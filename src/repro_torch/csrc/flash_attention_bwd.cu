// The backward of causal flash attention (K7b), hand-written for Hopper.
//
// Replaces the gradient that the reference takes by differentiating
// src/repro/kernels/ops.py::flash_attention (its CPU path
// _flash_ref_chunked, l.271; the Pallas kernel flash_attention_pallas
// has no backward of its own), with the forward's semantics
// (csrc/flash_attention.cu): query head h reads kv head h / g, the causal
// mask is aligned at the end (key j <= i + Sk - Sq), ragged tails are
// masked, q, k, v, o and dO are read through their (b, h, s) strides with
// a unit-stride head dim. With lse the forward's row log-sum-exp (natural
// log) and scale = 1/sqrt(D):
//
//   P = exp(S·scale - lse), S = Q Kᵀ       (recomputed, never stored)
//   Δ_i = Σ_d dO_id O_id
//   dS = P ∘ (dO Vᵀ - Δ)
//   dQ = dS K · scale,   dK = dSᵀ Q · scale,   dV = Pᵀ dO
//
// dK and dV of a kv head sum over its g query heads. Inputs float32 or
// bfloat16, all arithmetic in float32, the gradients in the inputs' type.
//
// The CUDA-core body of K7b. Since bfloat16 inputs that TMA can address
// run the tensor-core body (csrc/flash_attention_bwd_tc.cu), this one takes
// what that body does not (kernels/flash_attention.py::backward_body_for):
// float32 (the float32-compute witness of training), head dims past 128
// or off the multiple of 8 (stablelm-12b's 160), and bfloat16 views whose
// pointer or (b, h, s) stride is not a multiple of 16 bytes.
//
// Two kernels, no atomics, so two runs give the same bits:
//
//   * dq_kernel: one block of 256 threads per (64-row query tile, query
//     head, batch entry). It forms Δ for its rows (kept in registers and
//     written to a float32 (B, Hq, Sq) buffer for the second kernel), then
//     walks the key tiles up to the diagonal: S and dO Vᵀ in one loop over
//     the head dim, P and dS in registers, dS through shared memory into
//     dQ's accumulators.
//   * dkv_kernel: one block per (64-key tile, kv head, batch entry). It
//     keeps its K and V tiles, loops over the g query heads of the group
//     and over the query tiles from the diagonal on, recomputes Sᵀ and
//     V dOᵀ, and accumulates dV = Pᵀ dO and dK = dSᵀ Q in registers (P, then
//     dS, through one shared tile), so the group's sum stays in the block.
//
// Thread t owns rows 4r..4r+3 (r = t / 16) of a 64 x 64 score tile and
// its columns 4c..4c+3 (c = t % 16), and for the accumulated products the
// rows 4r.. and the head-dim columns c + 16 j (j < DC, DC = 2·ceil(D/32):
// one instance per 32 of head dim, exact at every config's 64, 96, 128 and
// 160, 12 instances in all; the loads and stores mask d >= D). Every
// operand tile sits in shared memory d-major as float32 ([16·DC][LD]), so a
// score step reads one float4 of each of the four; the accumulating
// products read the d-major tiles across (two-way bank conflicts).
// Shared memory: (4·16·DC + 64)·LD floats (+ 128 floats of row data in
// dkv_kernel), 121 KB at D = 96, 156 KB at D = 128, up to D = 192.
//
// What bounds it on this card: the products, 10·D FLOP a unmasked
// (query, key) pair (14·D as executed: both kernels recompute S), on the
// CUDA cores in float32 FMAs (67 TFLOP/s) against the tensor cores' 989
// TFLOP/s bf16 that bound the work: 14.6 TFLOP/s, 35 ms a phi3-mini
// layer on an H100, where the tensor-core body takes 2.6.
//
// Built with --fmad=false; the products use explicit __fmaf_rn.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;
constexpr int LD = 68;        // row stride of the d-major tiles (float4-aligned)
constexpr float LOG2E = 1.4426950408889634f;

// (b, h, s) element strides of q, k, v, o and dO, in that order
struct Strides {
  long long s[15];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float group16_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// rows [r0, r0 + 64) of a (S, D) slice with row stride `ss` into the
// d-major tile t[16·DC][LD] as float32, zero past S and past D
template <typename T, int DC>
__device__ __forceinline__ void load_tile(float* t, const T* src, long long ss, int r0, int S,
                                          int D) {
  constexpr int DV = 16 * DC;
  for (int i = threadIdx.x; i < 64 * DV; i += THREADS) {
    const int row = i / DV, d = i - row * DV;
    t[d * LD + row] = r0 + row < S && d < D ? to_f(src[(r0 + row) * ss + d]) : 0.0f;
  }
}

// a[i][j] += x[d][4·ra + i] · y[d][4·ca + j] and b[i][j] += u[d][..] ·
// w[d][..] over d < D: the two score products of a tile pair
__device__ __forceinline__ void two_products(float (&a)[4][4], float (&b)[4][4],
                                             const float* x, const float* y,
                                             const float* u, const float* w, int ra,
                                             int ca, int D) {
  for (int d = 0; d < D; ++d) {
    const float4 xa = *reinterpret_cast<const float4*>(x + d * LD + 4 * ra);
    const float4 ya = *reinterpret_cast<const float4*>(y + d * LD + 4 * ca);
    const float4 ua = *reinterpret_cast<const float4*>(u + d * LD + 4 * ra);
    const float4 wa = *reinterpret_cast<const float4*>(w + d * LD + 4 * ca);
    const float xv[4] = {xa.x, xa.y, xa.z, xa.w}, yv[4] = {ya.x, ya.y, ya.z, ya.w};
    const float uv[4] = {ua.x, ua.y, ua.z, ua.w}, wv[4] = {wa.x, wa.y, wa.z, wa.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[i][j] = __fmaf_rn(xv[i], yv[j], a[i][j]);
        b[i][j] = __fmaf_rn(uv[i], wv[j], b[i][j]);
      }
  }
}

// acc[i][j] += Σ_n p[n][4·r + i] · t[c + 16 j][n] over n < count: p a
// score tile stored [n][LD], t a d-major operand tile
template <int DC>
__device__ __forceinline__ void accumulate(float (&acc)[4][DC], const float* p,
                                           const float* t, int r, int c, int count) {
  for (int n = 0; n < count; ++n) {
    const float4 pa = *reinterpret_cast<const float4*>(p + n * LD + 4 * r);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const float tv = t[(c + 16 * j) * LD + n];
      acc[0][j] = __fmaf_rn(pa.x, tv, acc[0][j]);
      acc[1][j] = __fmaf_rn(pa.y, tv, acc[1][j]);
      acc[2][j] = __fmaf_rn(pa.z, tv, acc[2][j]);
      acc[3][j] = __fmaf_rn(pa.w, tv, acc[3][j]);
    }
  }
}

template <int DC>
__host__ __device__ constexpr int smem_floats(bool dkv) {
  return (4 * 16 * DC + 64) * LD + (dkv ? 2 * BQ : 0);
}

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dO,
          const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq,
          int group, int Sq, int Sk, int D, Strides st, float qscale, float scale,
          int causal) {
  constexpr int DV = 16 * DC;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [DV][LD] query rows
  float* Ot = Qt + DV * LD;                       // [DV][LD] dO rows
  float* Kt = Ot + DV * LD;                       // [DV][LD] key rows
  float* Vt = Kt + DV * LD;                       // [DV][LD] value rows
  float* Ss = Vt + DV * LD;                       // [BK][LD] dS, key-major

  const int tid = threadIdx.x;
  const int r = tid >> 4, c = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const long long* s = st.s;
  const T* qb = q + b * s[0] + h * s[1];
  const T* kb = k + b * s[3] + (h / group) * s[4];
  const T* vb = v + b * s[6] + (h / group) * s[7];
  const T* ob = o + b * s[9] + h * s[10];
  const T* db = dO + b * s[12] + h * s[13];
  const long long row_base = ((long long)b * gridDim.y + h) * Sq;
  const int shift = Sk - Sq;

  load_tile<T, DC>(Qt, qb, s[2], q0, Sq, D);
  load_tile<T, DC>(Ot, db, s[14], q0, Sq, D);

  // Δ and the base-2 log-sum-exp of this thread's four rows
  float dl[4], l2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * r + i;
    float part = 0.0f;
    if (row < Sq)
      for (int j = 0; j < DC; ++j) {
        const int col = c + 16 * j;
        if (col < D)
          part = __fmaf_rn(to_f(db[row * s[14] + col]), to_f(ob[row * s[11] + col]), part);
      }
    dl[i] = group16_sum(part);
    l2[i] = row < Sq ? __fmul_rn(lse[row_base + row], LOG2E) : 0.0f;
    if (row < Sq && c == 0) delta[row_base + row] = dl[i];
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;

  const int kend = causal ? min(Sk, min(q0 + BQ, Sq) + shift) : Sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();   // the previous tile's dS and K are consumed
    load_tile<T, DC>(Kt, kb, s[5], k0, Sk, D);
    load_tile<T, DC>(Vt, vb, s[8], k0, Sk, D);
    __syncthreads();

    float sc[4][4] = {}, dp[4][4] = {};
    two_products(sc, dp, Qt, Kt, Ot, Vt, r, c, D);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + 4 * c + j;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * r + i;
        const bool in = row < Sq && key < Sk && (!causal || key <= row + shift);
        const float p = in ? exp2f(__fmaf_rn(sc[i][j], qscale, -l2[i])) : 0.0f;
        ds[i] = __fmul_rn(p, __fsub_rn(dp[i][j], dl[i]));
      }
      *reinterpret_cast<float4*>(Ss + (4 * c + j) * LD + 4 * r) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    accumulate<DC>(acc, Ss, Kt, r, c, min(BK, Sk - k0));
  }

  T* out = dq + row_base * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * r + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int col = c + 16 * j;
      if (col < D) store(out + (long long)row * D + col, __fmul_rn(acc[i][j], scale));
    }
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dO, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
           int group, int Hq, int Sq, int Sk, int D, Strides st, float qscale, float scale,
           int causal) {
  constexpr int DV = 16 * DC;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);   // [DV][LD] key rows
  float* Vt = Kt + DV * LD;                       // [DV][LD] value rows
  float* Qt = Vt + DV * LD;                       // [DV][LD] query rows
  float* Ot = Qt + DV * LD;                       // [DV][LD] dO rows
  float* Ps = Ot + DV * LD;                       // [BQ][LD] P, then dS, query-major
  float* l2s = Ps + BQ * LD;                      // [BQ] base-2 log-sum-exp
  float* dls = l2s + BQ;                          // [BQ] Δ

  const int tid = threadIdx.x;
  const int r = tid >> 4, c = tid & 15;   // keys 4r.., queries 4c..
  const int k0 = blockIdx.x * BK;         // low keys (the most queries) first
  const int hk = blockIdx.y, b = blockIdx.z;
  const long long* s = st.s;
  const int shift = Sk - Sq;

  load_tile<T, DC>(Kt, k + b * s[3] + hk * s[4], s[5], k0, Sk, D);
  load_tile<T, DC>(Vt, v + b * s[6] + hk * s[7], s[8], k0, Sk, D);

  float ak[4][DC], av[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) ak[i][j] = av[i][j] = 0.0f;

  // the first query row that sees key k0, rounded down to its tile
  const int first = causal ? max(0, k0 - shift) / BQ * BQ : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * s[0] + h * s[1];
    const T* db = dO + b * s[12] + h * s[13];
    const long long row_base = ((long long)b * Hq + h) * Sq;
    for (int q0 = first; q0 < Sq; q0 += BQ) {
      __syncthreads();   // the previous tile's dS, Q and dO are consumed
      load_tile<T, DC>(Qt, qb, s[2], q0, Sq, D);
      load_tile<T, DC>(Ot, db, s[14], q0, Sq, D);
      if (tid < BQ) {
        const int row = q0 + tid;
        l2s[tid] = row < Sq ? __fmul_rn(lse[row_base + row], LOG2E) : 0.0f;
        dls[tid] = row < Sq ? delta[row_base + row] : 0.0f;
      }
      __syncthreads();

      // Sᵀ and V dOᵀ: key 4r + i against query 4c + j
      float sc[4][4] = {}, dp[4][4] = {};
      two_products(sc, dp, Kt, Qt, Vt, Ot, r, c, D);
      float ds[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + 4 * c + j;
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 4 * r + i;
          const bool in = row < Sq && key < Sk && (!causal || key <= row + shift);
          p[i] = in ? exp2f(__fmaf_rn(sc[i][j], qscale, -l2s[4 * c + j])) : 0.0f;
          ds[i][j] = __fmul_rn(p[i], __fsub_rn(dp[i][j], dls[4 * c + j]));
        }
        *reinterpret_cast<float4*>(Ps + (4 * c + j) * LD + 4 * r) =
            make_float4(p[0], p[1], p[2], p[3]);
      }
      __syncthreads();
      const int count = min(BQ, Sq - q0);
      accumulate<DC>(av, Ps, Ot, r, c, count);
      __syncthreads();   // every P is read: dS takes its place
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(Ps + (4 * c + j) * LD + 4 * r) =
            make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
      __syncthreads();
      accumulate<DC>(ak, Ps, Qt, r, c, count);
    }
  }

  const long long base = ((long long)b * gridDim.y + hk) * Sk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * r + i;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int col = c + 16 * j;
      if (col < D) {
        store(dk + base + (long long)key * D + col, __fmul_rn(ak[i][j], scale));
        store(dv + base + (long long)key * D + col, av[i][j]);
      }
    }
  }
}

template <typename T, int DC>
int launch_dc(const void* q, const void* k, const void* v, const void* o, const void* dO,
              const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Hq,
              int Hkv, int Sq, int Sk, int D, const Strides& st, float qscale, float scale,
              int causal, cudaStream_t stream) {
  const int group = Hq / Hkv;
  const size_t smem_q = sizeof(float) * smem_floats<DC>(false);
  const size_t smem_kv = sizeof(float) * smem_floats<DC>(true);
  auto kq = dq_kernel<T, DC>;
  auto kkv = dkv_kernel<T, DC>;
  cudaError_t err =
      cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dO);
  kq<<<dim3((Sq + BQ - 1) / BQ, Hq, B), THREADS, smem_q, stream>>>(
      tq, tk, tv, static_cast<const T*>(o), tdo, lse, delta, static_cast<T*>(dq), group,
      Sq, Sk, D, st, qscale, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kkv<<<dim3((Sk + BK - 1) / BK, Hkv, B), THREADS, smem_kv, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), group, Hq,
      Sq, Sk, D, st, qscale, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const void* o, const void* dO,
             const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Hq,
             int Hkv, int Sq, int Sk, int D, const Strides& st, float qscale, float scale,
             int causal, cudaStream_t stream) {
#define K7B_CASE(N)                                                                    \
  case N:                                                                              \
    return launch_dc<T, N>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk, \
                           D, st, qscale, scale, causal, stream);
  switch (2 * ((D + 31) / 32)) {
    K7B_CASE(2) K7B_CASE(4) K7B_CASE(6) K7B_CASE(8) K7B_CASE(10) K7B_CASE(12)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K7B_CASE
}

}  // namespace

// Shared memory (bytes) of the dQ and the dK/dV launch at head dim D.
extern "C" int flash_attention_bwd_smem_bytes(int D, int dkv) {
  const int dc = 2 * ((D + 31) / 32);
  return static_cast<int>(sizeof(float)) * ((4 * 16 * dc + 64) * LD + (dkv ? 2 * BQ : 0));
}

// q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), o and dO (B, Hq, Sq, D), each
// with unit stride along D and element strides st = {q, k, v, o, dO: b, h,
// s}; lse float32 (B, Hq, Sq) contiguous (the forward's, natural log);
// delta float32 (B, Hq, Sq) scratch; dq (B, Hq, Sq, D), dk and dv (B, Hkv,
// Sk, D) contiguous outputs. dtype 0 = float32, 1 = bfloat16; qscale =
// log2(e)/sqrt(D), scale = 1/sqrt(D); D <= 192. Two launches on `stream`;
// returns the first failing cudaError_t, or 0.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dO, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv,
                                          int dtype, int B, int Hq, int Hkv, int Sq, int Sk,
                                          int D, const long long* strides, float qscale,
                                          float scale, int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || D < 1 || D > 192 || Sk <= 0 || B > 65535 || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 15; ++i) st.s[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* L = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return launch_t<float>(q, k, v, o, dO, L, dl, dq, dk, dv, B, Hq, Hkv, Sq, Sk, D, st,
                           qscale, scale, causal, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, o, dO, L, dl, dq, dk, dv, B, Hq, Hkv, Sq, Sk,
                                   D, st, qscale, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
