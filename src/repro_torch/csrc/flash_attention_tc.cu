// Causal flash attention on the tensor cores, hand-written for Hopper: the
// bfloat16 body of K7.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_pallas (body:
//   _kernel) for bfloat16 inputs, with the semantics of
//   csrc/flash_attention.cu (the float32 CUDA-core body, which takes every
//   other input; kernels/flash_attention.py::body_for picks):
//
//   o[b,h,i,:] = sum_j softmax_j(q[b,h,i,:] . k[b,h/g,j,:] / sqrt(D)) v[b,h/g,j,:]
//
// over the keys j < Sk with, when causal, j <= i + (Sk - Sq) (the mask
// aligned at the end); any Sq, Sk, ragged tails masked; query head h reads
// kv head h / g in place; the output bfloat16.
//
// What bounds it on this card: the two products, 4·D FLOP per unmasked
// (query, key) pair, against 989 TFLOP/s of dense bf16 on the tensor cores;
// the softmax's exp2 (16 per clock per SM) comes second. So both products
// are wgmma, fed from shared memory that TMA fills, and the CUDA cores only
// scale, mask and exponentiate:
//
//   * A CTA takes 128 query rows of one (batch entry, query head) in three
//     warpgroups. Warpgroup 0 is the producer: it gives up registers
//     (setmaxnreg 40) and one of its threads issues every TMA load: Q once,
//     then K and V tiles of BK keys into a ring of STAGES stages, each with
//     a full barrier per operand and one empty barrier, which the eight
//     consumer warps arrive on once both products have read the stage.
//     Warpgroups 1 and 2 are the consumers (setmaxnreg 232), 64 query rows
//     each; while one exponentiates, the other's products run.
//   * S = Q K^T: wgmma m64nBKk16 bf16 x bf16 -> float32, A (Q) and B (K,
//     K-major) read from shared memory, the k-loop stopping at ceil(D/16).
//     The float32 scores are scaled by log2(e)/sqrt(D) there (Q is not
//     pre-scaled or re-rounded), masked only on tiles that cross the
//     diagonal or the ragged edge, and folded into the running max m and
//     sum l of each row (two rows per thread, reduced over the 4 threads
//     of a quad).
//   * O += P V: P = exp2(S·scale - m) is rounded to bfloat16 in registers
//     and used as wgmma's register A operand (the m64nNk16 accumulator
//     layout of S is the A layout of the next product, 16 keys a slice);
//     V is the B operand, read transposed from its [key][d] tile
//     (MN-major). l sums the float32 P, before that rounding, as the plain
//     version does; the rounding adds ~2^-9 relative error to O.
//   * Tiles are 128-byte-swizzled boxes of 64 head-dim columns (one box per
//     64 of the padded D, 1024-byte aligned), as TMA writes them and wgmma's
//     descriptors read them. The tensor maps are 4-D, (D, S, H, B) with the
//     strides of the caller's (B, H, S, D) view, so the model's transposed
//     views load in place; TMA's zero fill covers the ragged S tail and a
//     head dim below the padded one.
//   * D is padded at compile time to DP = 64, 128, 192 or 256, with BK =
//     128, 128, 64, 64 keys per tile and a ring of 3, 3, 3, 2 stages, so Q
//     and the ring fit 227 KB. Every instance compiles without a spill
//     (ptxas -v, CUDA 12.9); the barrier wait has no timeout, because a
//     trap path in it made ptxas spill up to 5 KB of the accumulators. The
//     heaviest causal tiles launch first: the query tile is the grid's
//     slowest index, reversed.
//
// For training, a launch may also write each row's log-sum-exp (natural
// log, float32 (B, Hq, Sq)): (m + log2 l)·ln 2 from the row's running max
// and quad-reduced sum, by the quad's first lane after the last tile. The
// serving path passes a null pointer and nothing more is written; ptxas
// still reports no spill with it.
//
// Built with --fmad=false like the other sources: the scaling uses explicit
// __fmaf_rn.
#include <math.h>

#include "hopper_tc.cuh"

namespace {

constexpr int BQ = 128;       // query rows per CTA: two consumer warpgroups
constexpr int THREADS = 384;  // warpgroup 0 loads, 1 and 2 compute

template <int DP>
struct Tile {
  // keys per K/V tile and the ring's depth (shared memory: 113, 225, 193
  // and 193 KB at DP = 64, 128, 192, 256)
  static constexpr int BK = DP <= 128 ? 128 : 64;
  static constexpr int STAGES = DP == 256 ? 2 : 3;
  static constexpr int BOXES = DP / 64;  // 128-byte swizzle boxes per row
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;  // one K or V stage
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // the barriers: Q full, K full, V full and empty per stage; + alignment
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * STAGES);
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                          int group, int Sq, int Sk, int D, float qscale, int causal) {
  using T = Tile<DP>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sQ = raw + ((1024 - (raw & 1023)) & 1023);  // [box][BQ][64]
  const uint32_t sK = sQ + T::Q_BYTES;                       // [stage][box][BK][64]
  const uint32_t sV = sK + T::STAGES * T::KV_BYTES;          // [stage][box][BK][64]
  const uint32_t q_full = sQ + T::BAR_OFF;
  const uint32_t k_full = q_full + 8;                 // + 8 * stage
  const uint32_t v_full = k_full + 8 * T::STAGES;
  const uint32_t empty = v_full + 8 * T::STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int shift = Sk - Sq;
  // keys the tile needs: up to its last row's position when causal
  const int kend = causal ? min(Sk, min(q0 + BQ, Sq) + shift) : Sk;
  const int ntiles = (kend + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warp-uniform as the compiler sees it, so that setmaxnreg's register
  // budgets apply to each role's code
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {  // producer
    regs_down<40>();
    if (threadIdx.x == 0) {
      const int hk = h / group;
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int x = 0; x < T::BOXES; ++x)
        tma_load(sQ + x * BQ * 128, &qmap, q_full, 64 * x, q0, h, b);
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % T::STAGES;
        mbar_wait(empty + 8 * s, ((n / T::STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, T::KV_BYTES);
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(sK + s * T::KV_BYTES + x * BK * 128, &kmap, k_full + 8 * s,
                   64 * x, n * BK, hk, b);
        mbar_expect_tx(v_full + 8 * s, T::KV_BYTES);
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(sV + s * T::KV_BYTES + x * BK * 128, &vmap, v_full + 8 * s,
                   64 * x, n * BK, hk, b);
      }
    }
  } else {  // consumers
    regs_up<232>();
    const int t = threadIdx.x - 128 * wg;
    const int lane = t % 32;
    const int first_row = q0 + 64 * (wg - 1);  // the warpgroup's rows
    // this thread's rows row0 and row0 + 8, columns 8 j + col0 + {0, 1}
    const int row0 = first_row + 16 * (t / 32) + lane / 4;
    const int col0 = 2 * (lane % 4);
    const int nks = (D + 15) / 16;  // QK^T k-slices
    const uint32_t qa = sQ + 64 * (wg - 1) * 128;

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

    mbar_wait(q_full, 0);
    for (int n = 0; n < ntiles; ++n) {
      const int s = n % T::STAGES;
      const uint32_t parity = (n / T::STAGES) & 1;
      const int k0 = n * BK;

      // S = Q K^T (float32 in registers: element 4 j + 2 i + c is row
      // row0 + 8 i, key k0 + 8 j + col0 + c)
      float sc[BK / 2];
      mbar_wait(k_full + 8 * s, parity);
      hold(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        if (kk < nks)
          wgmma_ss(sc, sw128_desc(qa + (kk / 4) * (BQ * 128) + (kk % 4) * 32, 16, 1024),
                   sw128_desc(sK + s * T::KV_BYTES + (kk / 4) * (BK * 128) + (kk % 4) * 32,
                              16, 1024),
                   kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      hold(sc);

      if (k0 + BK > Sk || (causal && k0 + BK - 1 > first_row + shift)) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int last = causal ? min(Sk - 1, row0 + 8 * i + shift) : Sk - 1;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (k0 + 8 * j + col0 + c > last) sc[4 * j + 2 * i + c] = -INFINITY;
        }
      }

      // online softmax in base 2 on the scaled scores
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], __fmul_rn(mx, qscale));
        // a row that has seen no key yet keeps m = -inf: exponentiate from 0
        const float base = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = exp2f(__fsub_rn(m[i], base));
        m[i] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(__fmaf_rn(sc[4 * j + 2 * i + c], qscale, -base));
            sc[4 * j + 2 * i + c] = p;
            sum = __fadd_rn(sum, p);
          }
        l[i] = __fmaf_rn(alpha, l[i], sum);
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          acc[4 * j + 2 * i] = __fmul_rn(acc[4 * j + 2 * i], alpha);
          acc[4 * j + 2 * i + 1] = __fmul_rn(acc[4 * j + 2 * i + 1], alpha);
        }
      }

      // P as wgmma's A operand: 16 keys per slice, the S layout's registers
      // 8 kk .. 8 kk + 7 in pairs
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // O += P V
      mbar_wait(v_full + 8 * s, parity);
      hold(acc);
      hold(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, pa[kk],
                 sw128_desc(sV + s * T::KV_BYTES + kk * 16 * 128, BK * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait_all();
      hold(acc);
      hold(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 1));
      l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 2));
    }
    __nv_bfloat16* ob = o + (static_cast<long long>(b) * gridDim.x + h) * Sq * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= Sq) continue;
      if (lse != nullptr && col0 == 0)
        lse[(static_cast<long long>(b) * gridDim.x + h) * Sq + row] =
            __fmul_rn(__fadd_rn(m[i], log2f(l[i])), 0.69314718055994531f);
      const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + col0;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(row) * D + col) =
              __floats2bfloat162_rn(__fdiv_rn(acc[4 * j + 2 * i], li),
                                    __fdiv_rn(acc[4 * j + 2 * i + 1], li));
      }
    }
  }
}


template <int DP>
int launch_dp(const void* q, const void* k, const void* v, void* o, float* lse, int B,
              int Hq, int Hkv, int Sq, int Sk, int D, const long long* st, float qscale,
              int causal, cudaStream_t stream) {
  using T = Tile<DP>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return MAP_ERROR + CUDA_ERROR_NOT_FOUND;
  CUtensorMap maps[3];
  CUresult r = make_map(encode, &maps[0], q, B, Hq, Sq, D, st, BQ);
  if (r == CUDA_SUCCESS) r = make_map(encode, &maps[1], k, B, Hkv, Sk, D, st + 3, T::BK);
  if (r == CUDA_SUCCESS) r = make_map(encode, &maps[2], v, B, Hkv, Sk, D, st + 6, T::BK);
  if (r != CUDA_SUCCESS) return MAP_ERROR + static_cast<int>(r);
  auto kern = flash_attention_tc_kernel<DP>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, T::SMEM, stream>>>(maps[0], maps[1], maps[2],
                                           static_cast<__nv_bfloat16*>(o), lse, Hq / Hkv,
                                           Sq, Sk, D, qscale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory (bytes) a launch at head dim D takes.
extern "C" int flash_attention_tc_smem_bytes(int D) {
  if (D <= 64) return Tile<64>::SMEM;
  if (D <= 128) return Tile<128>::SMEM;
  return D <= 192 ? Tile<192>::SMEM : Tile<256>::SMEM;
}

// flash_attention_launch's interface (csrc/flash_attention.cu): q (B, Hq,
// Sq, D), k and v (B, Hkv, Sk, D) with unit stride along D and element
// strides st = {q: b, h, s; k: b, h, s; v: b, h, s}; o (B, Hq, Sq, D)
// contiguous; lse null or float32 (B, Hq, Sq) contiguous, then written;
// qscale = log2(e)/sqrt(D). Here dtype must be 1 (bfloat16),
// D % 8 == 0, D <= 256 and every stride and pointer a multiple of 16
// bytes. Returns the launch's cudaError_t, or MAP_ERROR + libcuda's
// CUresult when a tensor map cannot be made.
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                                         void* o, void* lse, int dtype, int B, int Hq,
                                         int Hkv, int Sq, int Sk, int D,
                                         const long long* strides, float qscale,
                                         int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (dtype != 1 || Hkv <= 0 || Hq % Hkv || D < 8 || D > 256 || D % 8 || Sk <= 0 ||
      B > 65535 || Hq > 65535 || (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* L = static_cast<float*>(lse);
  if (D <= 64)
    return launch_dp<64>(q, k, v, o, L, B, Hq, Hkv, Sq, Sk, D, strides, qscale, causal, s);
  if (D <= 128)
    return launch_dp<128>(q, k, v, o, L, B, Hq, Hkv, Sq, Sk, D, strides, qscale, causal, s);
  if (D <= 192)
    return launch_dp<192>(q, k, v, o, L, B, Hq, Hkv, Sq, Sk, D, strides, qscale, causal, s);
  return launch_dp<256>(q, k, v, o, L, B, Hq, Hkv, Sq, Sk, D, strides, qscale, causal, s);
}
