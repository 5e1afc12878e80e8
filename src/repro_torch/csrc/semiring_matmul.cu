// Weighted tropical (min,+) matrix product, hand-written for Hopper (K5).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/semiring_matmul.py::tropical_matmul_pallas (body:
//   _kernel).
//
//   C[b,i,j] = min_k fma(av[b,i]*gv[b,k], bv[b,j], A[b,i,k] + B[b,k,j])
//
// with A + B and av*gv each rounded to float32 and the weighted term fused
// into one multiply-add, the rounding of the reference on the CPU (XLA
// contracts it there); without weights the candidate is A + B. The running
// min starts at +inf and keeps a NaN once it has seen one (torch.amin's
// rule), so the result equals the plain version bit for bit.
//
// Mapping: one 16 x 16 thread block per 16 x 16 output tile of one batch
// entry, one thread per output; K runs in tiles of 16 through shared memory
// (A, B and gv), ragged edges padded with +inf (A, B) and 0 (gv). Any
// shape works; the TPU kernel's block-divisibility error is not copied.
// Output tiles go on gridDim.x, the batch on gridDim.z in chunks of at
// most 65535.
//
// What bounds it on this card: (min,+) has no tensor-core form, so each
// candidate is an add, a min and, weighted, a multiply and an FMA on the
// CUDA cores (float32 at 67 TFLOP/s); operands are read once per output
// tile, so for K >> 16 it is operation-bound. Each thread makes two
// shared-memory loads per candidate, which caps this simple design well
// below that bound; register tiling (several outputs per thread) is later
// work (PERF.md).
//
// Built with --fmad=false; the only FMA is the explicit __fmaf_rn.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;

template <bool WEIGHTED>
__global__ void tropical_matmul_kernel(const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       const float* __restrict__ av,
                                       const float* __restrict__ gv,
                                       const float* __restrict__ bv,
                                       float* __restrict__ c, int batch0,
                                       int M, int N, int K) {
  __shared__ float as[TILE][TILE + 1];  // [i][k]
  __shared__ float bs[TILE][TILE];      // [k][j]
  __shared__ float gs[TILE];
  const long long bt = (long long)batch0 + blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tiles_n = (N + TILE - 1) / TILE;
  const int i = (blockIdx.x / tiles_n) * TILE + ty;
  const int j = (blockIdx.x % tiles_n) * TILE + tx;
  const float* A = a + bt * M * K;
  const float* B = b + bt * K * N;
  float avi = 0.0f, bvj = 0.0f;
  if (WEIGHTED) {
    if (i < M) avi = av[bt * M + i];
    if (j < N) bvj = bv[bt * N + j];
  }
  float acc = INFINITY;
  for (int k0 = 0; k0 < K; k0 += TILE) {
    as[ty][tx] = (i < M && k0 + tx < K) ? A[(long long)i * K + k0 + tx]
                                         : INFINITY;
    bs[ty][tx] = (k0 + ty < K && j < N) ? B[(long long)(k0 + ty) * N + j]
                                         : INFINITY;
    if (WEIGHTED && ty == 0)
      gs[tx] = (k0 + tx < K) ? gv[bt * K + k0 + tx] : 0.0f;
    __syncthreads();
    const int kn = min(TILE, K - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float v = __fadd_rn(as[ty][kk], bs[kk][tx]);
      if (WEIGHTED) v = __fmaf_rn(__fmul_rn(avi, gs[kk]), bvj, v);
      if (v < acc || isnan(v)) acc = v;
    }
    __syncthreads();
  }
  if (i < M && j < N) c[bt * M * N + (long long)i * N + j] = acc;
}

}  // namespace

// a (batch, M, K), b (batch, K, N), c (batch, M, N) f32 contiguous; av
// (batch, M), gv (batch, K), bv (batch, N) or all null. Returns
// cudaGetLastError().
extern "C" int tropical_matmul_launch(const void* a, const void* b,
                                      const void* av, const void* gv,
                                      const void* bv, void* c, int batch,
                                      int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 threads(TILE, TILE);
  const bool weighted = av != nullptr;
  for (int b0 = 0; b0 < batch; b0 += 65535) {
    const int nb = min(65535, batch - b0);
    const long long tiles =
        (long long)((N + TILE - 1) / TILE) * ((M + TILE - 1) / TILE);
    if (tiles == 0) break;
    if (tiles >= 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((unsigned)tiles, 1, nb);
    if (weighted)
      tropical_matmul_kernel<true><<<grid, threads, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<const float*>(av), static_cast<const float*>(gv),
          static_cast<const float*>(bv), static_cast<float*>(c), b0, M, N, K);
    else
      tropical_matmul_kernel<false><<<grid, threads, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b), nullptr,
          nullptr, nullptr, static_cast<float*>(c), b0, M, N, K);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
