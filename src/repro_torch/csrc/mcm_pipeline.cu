// Diagonal pipeline for the canonical triangular split recurrence (MCM,
// optimal BST, polygon triangulation), hand-written for Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mcm_pipeline.py::mcm_pipeline_pallas and
//   ::mcm_pipeline_pallas_with_args (body: _make_kernel).
//
// On the diagonal-major table (off(d) = d*n - d(d-1)/2 is the first cell of
// diagonal d), one whole diagonal is finalized per step:
//   m[off(d)+t] = min_{0<=e<d} ((m[off(e)+t] + m[off(d-e-1)+e+1+t])
//                               + W[off(d)+t, e]),
// the association of the plain wavefront solver. Diagonal 0 is preset to 0
// (args -1); with args, split e wins only by strict improvement, scanning e
// ascending (argmin's first-occurrence rule).
//
// Mapping: one CTA per instance (grid = batch); thread t handles lane t of
// diagonal d, looping when n-1 > blockDim; __syncthreads() between
// diagonals. Every operand lives on an earlier diagonal. The TPU kernel's
// padded lanes, which spill garbage into later diagonals, are masked here.
//
// What bounds it on this card: the (cells, n-1) weight table, ~2n^3 bytes
// (2.1 GB at n = 1024), streams from device memory; the byte bound is the
// half of it the recurrence reads (e < d) at 3.35 TB/s. Its row-per-cell
// layout makes W[off(d)+t, e] a strided read across the threads of a warp:
// each warp-wide weight load touches 32 sectors, so the one SM that runs
// the CTA spends an L1 wavefront per thread per split, about n^3/6 of them:
// by count the largest term of the kernel's time, far above the byte and
// the arithmetic bound (PERF.md). The cost table (n(n+1)/2 floats, 2.1 MB
// at n = 1024) exceeds shared memory and stays in device memory / L2. A
// split-major weight layout, which makes the weight read coalesced, and
// more than one SM per instance are later work.
//
// Built with --fmad=false and no fast math.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ long long diag_off(long long d, long long n) {
  return d * n - (d * (d - 1)) / 2;
}

template <bool ARGS>
__global__ void mcm_pipeline_kernel(const float* __restrict__ wtab,
                                    float* st_all, int* args_all, int n,
                                    int L) {
  const long long b = blockIdx.x;
  const long long cells = (long long)n * (n + 1) / 2;
  float* st = st_all + b * cells;
  int* ar = ARGS ? args_all + b * cells : nullptr;
  const float* w = wtab + b * cells * L;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    st[i] = 0.0f;
    if (ARGS) ar[i] = -1;
  }
  __syncthreads();
  for (int d = 1; d < n; ++d) {
    const long long off_d = diag_off(d, n);
    for (int t = threadIdx.x; t < n - d; t += blockDim.x) {
      const float* wrow = w + (off_d + t) * L;
      float acc = INFINITY;
      int arg = 0;
      for (int e = 0; e < d; ++e) {
        const float left = st[diag_off(e, n) + t];
        const float right = st[diag_off(d - e - 1, n) + e + 1 + t];
        const float v = __fadd_rn(__fadd_rn(left, right), wrow[e]);
        if (v < acc) {
          acc = v;
          arg = e;
        }
      }
      st[off_d + t] = acc;
      if (ARGS) ar[off_d + t] = arg;
    }
    __syncthreads();
  }
}

}  // namespace

// wtab (batch, n(n+1)/2, L) f32 with L = max(n-1, 1); st (batch, cells) f32;
// args (batch, cells) int32 or null. Returns cudaGetLastError().
extern "C" int mcm_pipeline_launch(const void* wtab, void* st, void* args,
                                   int batch, int n, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int threads = ((L + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (args != nullptr)
    mcm_pipeline_kernel<true><<<batch, threads, 0, s>>>(
        static_cast<const float*>(wtab), static_cast<float*>(st),
        static_cast<int*>(args), n, L);
  else
    mcm_pipeline_kernel<false><<<batch, threads, 0, s>>>(
        static_cast<const float*>(wtab), static_cast<float*>(st), nullptr, n,
        L);
  return static_cast<int>(cudaGetLastError());
}
