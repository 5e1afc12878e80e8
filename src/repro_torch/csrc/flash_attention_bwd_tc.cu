// The backward of causal flash attention (K7b) on the tensor cores,
// hand-written for Hopper: the bfloat16 body.
//
// Replaces K7b's CUDA-core body (csrc/flash_attention_bwd.cu) for bfloat16
// inputs that TMA can address; kernels/flash_attention.py::backward_body_for
// picks. Like that body it has no Pallas counterpart: the reference takes
// the gradient by differentiating src/repro/kernels/ops.py::flash_attention
// (its CPU path _flash_ref_chunked, l.271). It computes the same function
// (the contract at the head of csrc/flash_attention_bwd.cu): query head h
// reads kv head h / g in place, the causal mask is aligned at the end (key
// j <= i + Sk - Sq), ragged tails are masked, q, k, v, o and dO are read
// through their (b, h, s) strides; with lse the forward's natural-log row
// log-sum-exp and scale = 1/sqrt(D),
//
//   P = exp(S·scale - lse), S = Q Kᵀ,  Δ_i = Σ_d dO_id O_id,
//   dS = P ∘ (dO Vᵀ - Δ),  dQ = dS K·scale,  dK = dSᵀ Q·scale,  dV = Pᵀ dO,
//
// dK and dV of a kv head summed over its g query heads, float32
// accumulators, the gradients in bfloat16.
//
// What bounds it on this card: the five products, 10·D FLOP per unmasked
// (query, key) pair, against 989 TFLOP/s of dense bf16 on the tensor cores
// (the exp2 of P comes second). Both kernels below recompute S and dO Vᵀ,
// so 14·D are executed, and the three products of width D run at the
// padded width DP; that is cheaper than atomics or a dS written to device
// memory (1.07 GB a phi3-mini layer). What the design does about it:
//
//   * Every product is a bf16 wgmma with float32 accumulators, its shared
//     operands brought in by 4-D TMA loads ((D, S, H, B) maps with the
//     caller's strides, zero fill past S and past D) into 128-byte-swizzled
//     boxes of 64 head-dim columns, as in the forward (flash_attention_tc.cu).
//     A k-loop over the head dim stops at ceil(D/16).
//   * Three launches, no atomics, so two runs give the same bits:
//     delta_tc_kernel writes each row's Δ and base-2 log-sum-exp
//     (lse·log2 e) into a float32 scratch of (2, B, Hq, Sp) rows, Sp = Sq
//     rounded up to 64 (zero past Sq); it reads O and dO once (bandwidth
//     bound, 0.07 ms at a phi3 layer). Then dq_tc_kernel and dkv_tc_kernel
//     read only those rows, never O.
//   * dq_tc_kernel: one CTA per (128 query rows, query head, batch entry),
//     the heaviest causal tiles first (reversed). Per key tile of 64:
//     S = Q Kᵀ and dP = dO Vᵀ as wgmma_ss (A and B K-major in the head dim);
//     P = exp2(S·log2e/sqrt(D) - lse·log2e) and dS = P ∘ (dP - Δ) in
//     registers; dS rounded to bf16 is the register A operand of
//     dQ += dS K (the m64nN accumulator layout is the next product's A
//     layout, as P is in the forward), K read MN-major from the same tile.
//   * dkv_tc_kernel: one CTA per (128 keys, kv head, batch entry), low key
//     tiles (the most queries) first. It keeps K and V, loops over the g
//     query heads and over their query tiles of 64 from the diagonal on,
//     and computes the transposed scores Sᵀ = K Qᵀ and dPᵀ = V dOᵀ
//     (wgmma_ss), so that Pᵀ and dSᵀ sit in registers as A operands of
//     dV += Pᵀ dO and dK += dSᵀ Q (wgmma_rs, dO and Q read MN-major). P and
//     dS never go through shared memory; the group's sums stay in registers.
//   * The register budget decides the CTA's shape. A dK/dV consumer at
//     DP = 128 keeps two 64 x 128 float32 accumulators (128 registers) and
//     the 64 x 64 Sᵀ and dPᵀ (64 more). A ninth, producer warp caps every
//     thread at 168 registers (the SM's four register-file quarters take
//     warps in turn, so one quarter holds three warps), and setmaxnreg did
//     not raise the forward's consumers under CUDA 12.9: that design spilt
//     4.4 KB and took 17.8 ms a phi3 layer on an H100. So a CTA is just the two
//     consumer warpgroups (256 threads, up to 255 registers; dK/dV uses
//     234, dQ 170, no spill), 64 rows each, and thread 0 also issues the
//     TMA loads into a ring of STAGES stages with a full and an empty
//     mbarrier each: the first STAGES at the start, then each stage again
//     once all eight warps have left it, polled without blocking at the
//     top of every tile and waited for only when the tile is needed now.
//   * DP = 64 or 128 (head dims 8..128 in steps of 8; phi3's 96 runs at
//     128: an MN-major operand 96 wide would need another swizzle; 160
//     stays on the CUDA cores: two 64 x 160 accumulators leave no room).
//     Shared memory: 97 and 193 KB (dQ), 99 and 195 KB (dK/dV) at DP = 64,
//     128. P and dS round to bf16 before their products, as FA3 does.
//
// Built with --fmad=false like the other sources: the scaling keeps
// explicit __fmaf_rn.
#include <math.h>

#include "hopper_tc.cuh"

namespace {

constexpr int THREADS = 256;    // two consumer warpgroups; thread 0 also issues the loads
constexpr int BQ = 128;         // dQ kernel: query rows per CTA
constexpr int BKV = 128;        // dK/dV kernel: keys per CTA
constexpr int ROW_PAD = 64;     // the row scratch's Sp: Sq rounded up to this
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct DqTile {
  static constexpr int BK = 64;       // keys per K/V stage
  static constexpr int STAGES = 4;
  static constexpr int Q_BYTES = BQ * DP * 2;   // Q or dO
  static constexpr int KV_BYTES = BK * DP * 2;  // one stage's K or V
  static constexpr int BAR_OFF = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
  // the barriers: Q and dO full; K and V full, and empty, per stage
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

template <int DP>
struct DkvTile {
  static constexpr int BQ2 = 64;      // queries per Q/dO stage
  static constexpr int STAGES = 4;
  static constexpr int KV_BYTES = BKV * DP * 2;  // K or V
  static constexpr int Q_BYTES = BQ2 * DP * 2;   // one stage's Q or dO
  static constexpr int ROW_BYTES = BQ2 * 4;      // one stage's lse or Δ rows
  static constexpr int ROW_OFF = 2 * KV_BYTES + 2 * STAGES * Q_BYTES;
  static constexpr int BAR_OFF = ROW_OFF + 2 * STAGES * ROW_BYTES;
  // the barriers: K and V full; Q, dO and rows full, and empty, per stage
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

// Thread 0's refills at the top of iteration n: each tile m >= STAGES goes
// into the stage that tile m - STAGES frees (all eight warps arrived on
// its empty barrier), up to STAGES - 1 tiles ahead. It waits only for the
// tile needed now; a stage not yet free is tried again next iteration.
template <class Issue>
__device__ __forceinline__ void refill(uint32_t empty, int stages, int n, int ntiles,
                                       int& next, Issue& issue) {
  while (next < ntiles && next < n + stages) {
    const uint32_t bar = empty + 8 * (next % stages);
    const uint32_t parity = ((next / stages) & 1) ^ 1;
    if (next == n)
      mbar_wait(bar, parity);
    else if (!mbar_try_wait(bar, parity))
      break;
    issue(next++);
  }
}

// Δ and lse·log2 e of every row into rows[2][B][Hq][Sp] (zero past Sq): a
// warp a row, 8 rows a block of grid (Sp / 8, Hq, B).
__global__ void __launch_bounds__(256)
delta_tc_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dO,
                const float* __restrict__ lse, float* __restrict__ rows, long long ob,
                long long oh, long long os, long long db, long long dh, long long ds,
                int Sq, int D, int Sp) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int h = blockIdx.y, b = blockIdx.z, Hq = gridDim.y;
  float part = 0.0f;
  if (row < Sq) {
    const __nv_bfloat16* orow = o + b * ob + h * oh + row * os;
    const __nv_bfloat16* drow = dO + b * db + h * dh + row * ds;
    for (int d = 2 * lane; d < D; d += 64) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(orow + d);
      const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(drow + d);
      part = __fmaf_rn(__bfloat162float(y.x), __bfloat162float(x.x), part);
      part = __fmaf_rn(__bfloat162float(y.y), __bfloat162float(x.y), part);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
  if (lane == 0) {
    const long long r = (static_cast<long long>(b) * Hq + h) * Sp + row;
    rows[r] = row < Sq ? __fmul_rn(lse[(static_cast<long long>(b) * Hq + h) * Sq + row], LOG2E)
                       : 0.0f;
    rows[static_cast<long long>(gridDim.z) * Hq * Sp + r] = part;
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
             const float* __restrict__ rows, __nv_bfloat16* __restrict__ dq, int group,
             int Sq, int Sk, int D, int Sp, float qscale, float scale, int causal) {
  using T = DqTile<DP>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sQ = raw + ((1024 - (raw & 1023)) & 1023);  // [box][BQ][64]
  const uint32_t sO = sQ + T::Q_BYTES;                       // dO: [box][BQ][64]
  const uint32_t sK = sO + T::Q_BYTES;                       // [stage][box][BK][64]
  const uint32_t sV = sK + T::STAGES * T::KV_BYTES;          // [stage][box][BK][64]
  const uint32_t q_full = sQ + T::BAR_OFF;
  const uint32_t full = q_full + 8;                          // + 8 * stage
  const uint32_t empty = full + 8 * T::STAGES;

  const int h = blockIdx.x, b = blockIdx.y, Hq = gridDim.x;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;          // heaviest tiles first
  const int shift = Sk - Sq;
  // keys the tile needs: up to its last row's position when causal
  const int kend = causal ? min(Sk, min(q0 + BQ, Sq) + shift) : Sk;
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // K and V of tile n into its stage (thread 0)
  auto issue = [&](int n) {
    const int s = n % T::STAGES, hk = h / group;
    mbar_expect_tx(full + 8 * s, 2 * T::KV_BYTES);
    for (int x = 0; x < DP / 64; ++x) {
      tma_load(sK + s * T::KV_BYTES + x * BK * 128, &kmap, full + 8 * s, 64 * x, n * BK, hk, b);
      tma_load(sV + s * T::KV_BYTES + x * BK * 128, &vmap, full + 8 * s, 64 * x, n * BK, hk, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, 2 * T::Q_BYTES);
    for (int x = 0; x < DP / 64; ++x) {
      tma_load(sQ + x * BQ * 128, &qmap, q_full, 64 * x, q0, h, b);
      tma_load(sO + x * BQ * 128, &dmap, q_full, 64 * x, q0, h, b);
    }
    for (int n = 0; n < min(ntiles, T::STAGES); ++n) issue(n);
  }
  int next = T::STAGES;  // thread 0: the next tile to load

  {
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x - 128 * wg;
    const int lane = t % 32;
    const int first_row = q0 + 64 * wg;  // the warpgroup's rows
    // this thread's rows row0 and row0 + 8, columns 8 j + col0 + {0, 1}
    const int row0 = first_row + 16 * (t / 32) + lane / 4;
    const int col0 = 2 * (lane % 4);
    const int nks = (D + 15) / 16;  // k-slices of the score products
    const uint32_t qa = sQ + 64 * wg * 128, oa = sO + 64 * wg * 128;
    const float* l2r = rows + (static_cast<long long>(b) * Hq + h) * Sp;
    const float* dlr = l2r + static_cast<long long>(gridDim.y) * Hq * Sp;
    float l2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      l2[i] = row < Sq ? l2r[row] : 0.0f;
      dl[i] = row < Sq ? dlr[row] : 0.0f;
    }

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;

    mbar_wait(q_full, 0);
    for (int n = 0; n < ntiles; ++n) {
      if (threadIdx.x == 0) refill(empty, T::STAGES, n, ntiles, next, issue);
      __syncwarp();
      const int s = n % T::STAGES;
      const int k0 = n * BK;
      const uint32_t kt = sK + s * T::KV_BYTES, vt = sV + s * T::KV_BYTES;

      // S = Q Kᵀ and dP = dO Vᵀ (float32 in registers: element 4 j + 2 i +
      // c is row row0 + 8 i, key k0 + 8 j + col0 + c)
      float sc[BK / 2], dp[BK / 2];
      mbar_wait(full + 8 * s, (n / T::STAGES) & 1);
      hold(sc);
      hold(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        if (kk < nks) {
          const uint32_t col = (kk / 4) * (BQ * 128) + (kk % 4) * 32;
          const uint32_t kcol = (kk / 4) * (BK * 128) + (kk % 4) * 32;
          wgmma_ss(sc, sw128_desc(qa + col, 16, 1024), sw128_desc(kt + kcol, 16, 1024), kk > 0);
          wgmma_ss(dp, sw128_desc(oa + col, 16, 1024), sw128_desc(vt + kcol, 16, 1024), kk > 0);
        }
      wgmma_commit();
      wgmma_wait_all();
      hold(sc);
      hold(dp);

      // dS = P ∘ (dP - Δ), masked only on tiles that cross the diagonal or
      // the ragged edge
      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > first_row + shift);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int last = causal ? min(Sk - 1, row0 + 8 * i + shift) : Sk - 1;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            float p = exp2f(__fmaf_rn(sc[e], qscale, -l2[i]));
            if (edge && k0 + 8 * j + col0 + c > last) p = 0.0f;
            sc[e] = __fmul_rn(p, __fsub_rn(dp[e], dl[i]));
          }
      }

      // dQ += dS K: dS as the register A operand, 16 keys a slice; K
      // read MN-major (its [key][d] tile transposed)
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) da[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      hold(acc);
      hold(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, da[kk], sw128_desc(kt + kk * 16 * 128, BK * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait_all();
      hold(acc);
      hold(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    __nv_bfloat16* out = dq + (static_cast<long long>(b) * Hq + h) * Sq * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= Sq) continue;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + col0;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * D + col) =
              __floats2bfloat162_rn(__fmul_rn(acc[4 * j + 2 * i], scale),
                                    __fmul_rn(acc[4 * j + 2 * i + 1], scale));
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
dkv_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
              const float* __restrict__ rows, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, int group, int Hq, int Sq, int Sk, int D, int Sp,
              float qscale, float scale, int causal) {
  using T = DkvTile<DP>;
  constexpr int BQ2 = T::BQ2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t sK = raw + pad;                         // [box][BKV][64]
  const uint32_t sV = sK + T::KV_BYTES;                  // [box][BKV][64]
  const uint32_t sQ = sV + T::KV_BYTES;                  // [stage][box][BQ2][64]
  const uint32_t sO = sQ + T::STAGES * T::Q_BYTES;       // dO: [stage][box][BQ2][64]
  const uint32_t sL = sK + T::ROW_OFF;                   // [stage][BQ2] lse·log2 e
  const uint32_t sD = sL + T::STAGES * T::ROW_BYTES;     // [stage][BQ2] Δ
  const float* rowL = reinterpret_cast<const float*>(smem_raw + pad + T::ROW_OFF);
  const float* rowD = rowL + T::STAGES * BQ2;
  const uint32_t kv_full = sK + T::BAR_OFF;
  const uint32_t full = kv_full + 8;                     // + 8 * stage
  const uint32_t empty = full + 8 * T::STAGES;

  const int hk = blockIdx.x, b = blockIdx.y, B = gridDim.y;
  const int k0 = blockIdx.z * BKV;  // low keys (the most queries) first
  const int shift = Sk - Sq;
  // the first query row that sees key k0, rounded down to its tile
  const int first = causal ? max(0, k0 - shift) / BQ2 * BQ2 : 0;
  const int per_head = first < Sq ? (Sq - first + BQ2 - 1) / BQ2 : 0;
  const int ntiles = group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Q, dO and their rows of tile n (query head n / per_head) into its
  // stage (thread 0)
  auto issue = [&](int n) {
    const int s = n % T::STAGES, g = n / per_head;
    const int h = hk * group + g, q0 = first + (n - g * per_head) * BQ2;
    mbar_expect_tx(full + 8 * s, 2 * T::Q_BYTES + 2 * T::ROW_BYTES);
    for (int x = 0; x < DP / 64; ++x) {
      tma_load(sQ + s * T::Q_BYTES + x * BQ2 * 128, &qmap, full + 8 * s, 64 * x, q0, h, b);
      tma_load(sO + s * T::Q_BYTES + x * BQ2 * 128, &dmap, full + 8 * s, 64 * x, q0, h, b);
    }
    const long long r = (static_cast<long long>(b) * Hq + h) * Sp + q0;
    bulk_load(sL + s * T::ROW_BYTES, rows + r, T::ROW_BYTES, full + 8 * s);
    bulk_load(sD + s * T::ROW_BYTES, rows + static_cast<long long>(B) * Hq * Sp + r,
              T::ROW_BYTES, full + 8 * s);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
    for (int x = 0; x < DP / 64; ++x) {
      tma_load(sK + x * BKV * 128, &kmap, kv_full, 64 * x, k0, hk, b);
      tma_load(sV + x * BKV * 128, &vmap, kv_full, 64 * x, k0, hk, b);
    }
    for (int n = 0; n < min(ntiles, T::STAGES); ++n) issue(n);
  }
  int next = T::STAGES;  // thread 0: the next tile to load

  {
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x - 128 * wg;
    const int lane = t % 32;
    const int first_key = k0 + 64 * wg;  // the warpgroup's keys
    // this thread's keys key0 and key0 + 8, queries 8 j + col0 + {0, 1}
    const int key0 = first_key + 16 * (t / 32) + lane / 4;
    const int col0 = 2 * (lane % 4);
    const int nks = (D + 15) / 16;
    const uint32_t ka = sK + 64 * wg * 128, va = sV + 64 * wg * 128;

    float ak[DP / 2], av[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) ak[i] = av[i] = 0.0f;

    mbar_wait(kv_full, 0);
    for (int n = 0; n < ntiles; ++n) {
      if (threadIdx.x == 0) refill(empty, T::STAGES, n, ntiles, next, issue);
      __syncwarp();
      const int s = n % T::STAGES;
      const int q0 = first + (n % per_head) * BQ2;
      const uint32_t qt = sQ + s * T::Q_BYTES, ot = sO + s * T::Q_BYTES;

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (element 4 j + 2 i + c is key key0 +
      // 8 i, query q0 + 8 j + col0 + c)
      float sc[BQ2 / 2], dp[BQ2 / 2];
      mbar_wait(full + 8 * s, (n / T::STAGES) & 1);
      hold(sc);
      hold(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        if (kk < nks) {
          const uint32_t kcol = (kk / 4) * (BKV * 128) + (kk % 4) * 32;
          const uint32_t qcol = (kk / 4) * (BQ2 * 128) + (kk % 4) * 32;
          wgmma_ss(sc, sw128_desc(ka + kcol, 16, 1024), sw128_desc(qt + qcol, 16, 1024), kk > 0);
          wgmma_ss(dp, sw128_desc(va + kcol, 16, 1024), sw128_desc(ot + qcol, 16, 1024), kk > 0);
        }
      wgmma_commit();
      wgmma_wait_all();
      hold(sc);
      hold(dp);

      // Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ - Δ), masked only on tiles that cross the
      // diagonal or the ragged edge
      const float* l2s = rowL + s * BQ2;
      const float* dls = rowD + s * BQ2;
      const bool edge = q0 + BQ2 > Sq || (causal && first_key + 63 > q0 + shift);
#pragma unroll
      for (int j = 0; j < BQ2 / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qc = 8 * j + col0 + c;
          const float l2 = l2s[qc], dl = dls[qc];
          const int query = q0 + qc;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i + c;
            float p = exp2f(__fmaf_rn(sc[e], qscale, -l2));
            if (edge && (query >= Sq || (causal && key0 + 8 * i > query + shift))) p = 0.0f;
            sc[e] = p;
            dp[e] = __fmul_rn(p, __fsub_rn(dp[e], dl));
          }
        }

      // dV += Pᵀ dO and dK += dSᵀ Q: Pᵀ and dSᵀ as register A operands, 16
      // queries a slice; dO and Q read MN-major
      uint32_t pa[BQ2 / 16][4], da[BQ2 / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ2 / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
          da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }
      hold(av);
      hold(ak);
      hold(pa);
      hold(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ2 / 16; ++kk)
        wgmma_rs(av, pa[kk], sw128_desc(ot + kk * 16 * 128, BQ2 * 128, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < BQ2 / 16; ++kk)
        wgmma_rs(ak, da[kk], sw128_desc(qt + kk * 16 * 128, BQ2 * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait_all();
      hold(av);
      hold(ak);
      hold(pa);
      hold(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    const long long base = (static_cast<long long>(b) * gridDim.x + hk) * Sk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      if (key >= Sk) continue;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + col0;
        if (col < D) {
          const long long at = (base + key) * D + col;
          *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
              __fmul_rn(ak[4 * j + 2 * i], scale), __fmul_rn(ak[4 * j + 2 * i + 1], scale));
          *reinterpret_cast<__nv_bfloat162*>(dv + at) =
              __floats2bfloat162_rn(av[4 * j + 2 * i], av[4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

template <int DP>
int launch_dp(const void* q, const void* k, const void* v, const void* o, const void* dO,
              const float* lse, float* rows, void* dq, void* dk, void* dv, int B, int Hq,
              int Hkv, int Sq, int Sk, int D, const long long* st, float qscale, float scale,
              int causal, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return MAP_ERROR + CUDA_ERROR_NOT_FOUND;
  // dQ kernel: Q and dO in boxes of BQ rows, K and V of BK; dK/dV kernel:
  // K and V in boxes of BKV rows, Q and dO of BQ2
  const int bk = DqTile<DP>::BK, bq2 = DkvTile<DP>::BQ2;
  CUtensorMap m[8];
  CUresult r = make_map(encode, &m[0], q, B, Hq, Sq, D, st, BQ);
  if (r == CUDA_SUCCESS) r = make_map(encode, &m[1], k, B, Hkv, Sk, D, st + 3, bk);
  if (r == CUDA_SUCCESS) r = make_map(encode, &m[2], v, B, Hkv, Sk, D, st + 6, bk);
  if (r == CUDA_SUCCESS) r = make_map(encode, &m[3], dO, B, Hq, Sq, D, st + 12, BQ);
  if (r == CUDA_SUCCESS) r = make_map(encode, &m[4], q, B, Hq, Sq, D, st, bq2);
  if (r == CUDA_SUCCESS) r = make_map(encode, &m[5], k, B, Hkv, Sk, D, st + 3, BKV);
  if (r == CUDA_SUCCESS) r = make_map(encode, &m[6], v, B, Hkv, Sk, D, st + 6, BKV);
  if (r == CUDA_SUCCESS) r = make_map(encode, &m[7], dO, B, Hq, Sq, D, st + 12, bq2);
  if (r != CUDA_SUCCESS) return MAP_ERROR + static_cast<int>(r);
  auto kq = dq_tc_kernel<DP>;
  auto kkv = dkv_tc_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DqTile<DP>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DkvTile<DP>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Sp = (Sq + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  delta_tc_kernel<<<dim3(Sp / 8, Hq, B), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dO), lse, rows,
      st[9], st[10], st[11], st[12], st[13], st[14], Sq, D, Sp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kq<<<dim3(Hq, B, (Sq + BQ - 1) / BQ), THREADS, DqTile<DP>::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], rows, static_cast<__nv_bfloat16*>(dq), Hq / Hkv, Sq, Sk, D, Sp,
      qscale, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kkv<<<dim3(Hkv, B, (Sk + BKV - 1) / BKV), THREADS, DkvTile<DP>::SMEM, stream>>>(
      m[4], m[5], m[6], m[7], rows, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Hq / Hkv, Hq, Sq, Sk, D, Sp, qscale, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory (bytes) of the dQ and the dK/dV launch at head dim D.
extern "C" int flash_attention_bwd_tc_smem_bytes(int D, int dkv) {
  if (D <= 64) return dkv ? DkvTile<64>::SMEM : DqTile<64>::SMEM;
  return dkv ? DkvTile<128>::SMEM : DqTile<128>::SMEM;
}

// flash_attention_bwd_launch's interface (csrc/flash_attention_bwd.cu),
// with `delta` a float32 scratch of 2 * B * Hq * Sp rows, Sp = Sq rounded
// up to 64. Here dtype must be 1 (bfloat16), D % 8 == 0, D <= 128 and every
// pointer and (b, h, s) stride a multiple of 16 bytes. Three launches on
// `stream`; returns the first failing cudaError_t, MAP_ERROR + libcuda's
// CUresult when a tensor map cannot be made, or 0.
extern "C" int flash_attention_bwd_tc_launch(const void* q, const void* k, const void* v,
                                             const void* o, const void* dO, const void* lse,
                                             void* delta, void* dq, void* dk, void* dv,
                                             int dtype, int B, int Hq, int Hkv, int Sq, int Sk,
                                             int D, const long long* strides, float qscale,
                                             float scale, int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (dtype != 1 || Hkv <= 0 || Hq % Hkv || D < 8 || D > 128 || D % 8 || Sk <= 0 ||
      B > 65535 || Hq > 65535 || (Sq + BQ - 1) / BQ > 65535 || (Sk + BKV - 1) / BKV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* L = static_cast<const float*>(lse);
  float* R = static_cast<float*>(delta);
  if (D <= 64)
    return launch_dp<64>(q, k, v, o, dO, L, R, dq, dk, dv, B, Hq, Hkv, Sq, Sk, D, strides,
                         qscale, scale, causal, s);
  return launch_dp<128>(q, k, v, o, dO, L, R, dq, dk, dv, B, Hq, Hkv, Sq, Sk, D, strides,
                        qscale, scale, causal, s);
}
