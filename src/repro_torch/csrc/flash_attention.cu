// Causal flash attention with an online softmax, hand-written for Hopper
// (K7).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_pallas (body:
//   _kernel), with the semantics of the reference's CPU path
//   src/repro/kernels/ops.py::_flash_ref_chunked, which the port's plain
//   version copies:
//
//   o[b,h,i,:] = sum_j softmax_j(q[b,h,i,:] . k[b,h/g,j,:] / sqrt(D)) v[b,h/g,j,:]
//
// over the keys j < Sk with, when causal, j <= i + (Sk - Sq) (the mask
// aligned at the end; the Pallas kernel aligns it at the start, which
// agrees only for Sq == Sk). Query head h reads kv head h / g, g = Hq/Hkv
// (jnp.repeat's order), indexed here instead of materialising the repeat.
// Any Sq, Sk: ragged tiles are masked (the Pallas kernel raises unless S
// divides its blocks). Inputs float32 or bfloat16, all arithmetic in
// float32, the output in the inputs' type.
//
// Mapping: one block of 256 threads per (64-row query tile, query head,
// batch entry); the heaviest causal tiles launch first. Thread t owns
// query rows 4r..4r+3 (r = t / 16) and, for the scores, keys 4c..4c+3 of
// the current 64-key tile (c = t % 16); for the output, columns
// c + 16 j (j < DC = ceil(D/16)). Q (scaled by log2(e)/sqrt(D)) and K sit
// in shared memory d-major, so a score step reads one float4 of each;
// V row-major; the probabilities P overwrite K's slot (d-major rows of
// keys) once the scores are read. Row max and row sum reduce over the 16
// threads of a row group by warp shuffles; m, l and the 4 x DC output
// accumulators live in registers. Shared memory: (2·D·68 + 64·16·DC)
// floats (+ 64·68 when D < 64), 102 KB at D = 128 (two blocks per SM),
// 128 KB at D = 160; D up to 256.
//
// What bounds it on this card: both products run on the CUDA cores in
// float32 FMAs (67 TFLOP/s counting an FMA as two), with two shared loads
// per 16 FMAs in the score loop and 1 + DC per 4·DC in the value loop; at
// the served shapes attention is operation-bound (its tensor-core bound,
// 989 TFLOP/s in bf16, is ~15x lower). Tensor cores (wgmma) and TMA are
// later work.
//
// For training, a launch may also write each row's log-sum-exp (natural
// log, float32 (B, Hq, Sq)): (m + log2 l)·ln 2 from the running max m and
// sum l of the scaled base-2 scores, by the row group's first thread. The
// serving path passes a null pointer and nothing more is written.
//
// Built with --fmad=false; the products use explicit __fmaf_rn.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;
constexpr int LD = BQ + 4;    // row stride of the d-major tiles (float4-aligned)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float group16_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int DC>
__host__ __device__ constexpr int smem_floats_for(int D) {
  return 2 * D * LD + BK * 16 * DC + (D < BK ? BK * LD : 0);
}

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int group,
                       int Sq, int Sk, int D, long long qsb, long long qsh,
                       long long qss, long long ksb, long long ksh,
                       long long kss, long long vsb, long long vsh,
                       long long vss, float qscale, int causal) {
  constexpr int DV = 16 * DC;   // padded row of the V tile
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][LD]
  float* Kt = Qt + D * LD;                        // [D][LD]
  float* Vs = Kt + D * LD;                        // [BK][DV]
  float* Ps = D >= BK ? Kt : Vs + BK * DV;        // [BK][LD]

  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int c = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / group) * ksh;
  const T* vb = v + b * vsb + (h / group) * vsh;
  const int shift = Sk - Sq;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int row = i / D, d = i - row * D;
    Qt[d * LD + row] =
        q0 + row < Sq ? __fmul_rn(to_f(qb[(q0 + row) * qss + d]), qscale) : 0.0f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;
  }

  // keys a causal tile needs: up to the last row's position
  const int kend = causal ? min(Sk, min(q0 + BQ, Sq) + shift) : Sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();   // the previous tile's P and V are consumed
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int key = i / DV, d = i - key * DV;
      const bool in = k0 + key < Sk && d < D;
      if (d < D) Kt[d * LD + key] = in ? to_f(kb[(k0 + key) * kss + d]) : 0.0f;
      Vs[key * DV + d] = in ? to_f(vb[(k0 + key) * vss + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * LD + 4 * r);
      const float4 ka = *reinterpret_cast<const float4*>(Kt + d * LD + 4 * c);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * r + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + 4 * c + j;
        if (key >= Sk || (causal && key > row + shift)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // every row sees key 0 in the first tile, so m_new is finite
      const float m_new = fmaxf(m[i], group16_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(__fsub_rn(s[i][j], m_new));
        sum = __fadd_rn(sum, s[i][j]);
      }
      const float alpha = exp2f(__fsub_rn(m[i], m_new));
      l[i] = __fmaf_rn(alpha, l[i], group16_sum(sum));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] = __fmul_rn(acc[i][j], alpha);
    }
    if (D >= BK) __syncthreads();   // P overwrites K: every score is read
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ps + (4 * c + j) * LD + 4 * r) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int kn = min(BK, Sk - k0);
    for (int key = 0; key < kn; ++key) {
      const float4 pa = *reinterpret_cast<const float4*>(Ps + key * LD + 4 * r);
      const float* vrow = Vs + key * DV + c;
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vv = vrow[16 * j];
        acc[0][j] = __fmaf_rn(pa.x, vv, acc[0][j]);
        acc[1][j] = __fmaf_rn(pa.y, vv, acc[1][j]);
        acc[2][j] = __fmaf_rn(pa.z, vv, acc[2][j]);
        acc[3][j] = __fmaf_rn(pa.w, vv, acc[3][j]);
      }
    }
  }

  T* ob = o + ((long long)b * gridDim.y + h) * (long long)Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * r + i;
    if (row >= Sq) continue;
    if (lse != nullptr && c == 0)
      lse[((long long)b * gridDim.y + h) * Sq + row] =
          __fmul_rn(__fadd_rn(m[i], log2f(l[i])), 0.69314718055994531f);
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int col = c + 16 * j;
      if (col < D) store(ob + (long long)row * D + col, __fdiv_rn(acc[i][j], li));
    }
  }
}

template <typename T, int DC>
int launch_dc(const void* q, const void* k, const void* v, void* o, float* lse, int B,
              int Hq, int group, int Sq, int Sk, int D, const long long* st,
              float qscale, int causal, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats_for<DC>(D);
  auto kern = flash_attention_kernel<T, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, group, Sq, Sk, D, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], qscale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o, float* lse, int B,
             int Hq, int group, int Sq, int Sk, int D, const long long* st,
             float qscale, int causal, cudaStream_t s) {
#define K7_CASE(N)                                                          \
  case N:                                                                   \
    return launch_dc<T, N>(q, k, v, o, lse, B, Hq, group, Sq, Sk, D, st, qscale, \
                           causal, s);
  switch ((D + 15) / 16) {
    K7_CASE(1) K7_CASE(2) K7_CASE(3) K7_CASE(4) K7_CASE(5) K7_CASE(6)
    K7_CASE(7) K7_CASE(8) K7_CASE(9) K7_CASE(10) K7_CASE(11) K7_CASE(12)
    K7_CASE(13) K7_CASE(14) K7_CASE(15) K7_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K7_CASE
}

}  // namespace

// Shared memory (bytes) a launch at head dim D takes.
extern "C" int flash_attention_smem_bytes(int D) {
  const int dc = (D + 15) / 16;
  return static_cast<int>(sizeof(float)) *
         (2 * D * LD + BK * 16 * dc + (D < BK ? BK * LD : 0));
}

// q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D) with unit stride along D and
// element strides st = {q: b, h, s; k: b, h, s; v: b, h, s}; o (B, Hq, Sq,
// D) contiguous; lse null or float32 (B, Hq, Sq) contiguous, then written.
// dtype 0 = float32, 1 = bfloat16; qscale = log2(e)/sqrt(D).
// Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int dtype, int B,
                                      int Hq, int Hkv, int Sq, int Sk, int D,
                                      const long long* strides, float qscale,
                                      int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || D < 1 || D > 256 || Sk <= 0 || B > 65535 ||
      Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  if (dtype == 0)
    return launch_t<float>(q, k, v, o, static_cast<float*>(lse), B, Hq, group, Sq, Sk, D, strides, qscale,
                           causal, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), B, Hq, group, Sq, Sk, D, strides,
                                   qscale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
