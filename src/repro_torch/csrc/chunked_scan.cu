// Gated linear scan h_t = decay_t * h_{t-1} + x_t, hand-written for Hopper
// (K8).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/chunked_scan.py::chunked_scan_pallas (body: _kernel).
//
// x, decay, h_all (T, D) and h0, h_last (D,), float32, contiguous. The TPU
// kernel walks (C x bd) chunks in order and carries the state in scratch;
// here one thread per feature walks all T rows with its state in a
// register, so the chunk has no role (the wrapper keeps the argument for
// the reference's signature). Each step rounds decay*h + x once
// (__fmaf_rn), as XLA's CPU compiler contracts the reference's d*h + x and
// as the plain version computes it (core.semiring.fma_f32), so kernel,
// plain version and reference are bit-equal.
//
// Mapping: blocks of 32 threads, one warp over 32 neighbouring features,
// so a row's loads and stores are one 128-byte line per warp and D/32
// blocks spread over the SMs; the loop is unrolled so that loads of later
// rows issue before the chain of earlier ones completes.
//
// What bounds it on this card: bytes (3 T D floats moved, 2 operations per
// element): at T = 32768, D = 2048, 805 MB, 0.24 ms at 3.35 TB/s. This
// simple mapping runs D threads only (2048 at rwkv6-1.6b's width), far too
// few to keep HBM busy; a chunked two-pass scan over many blocks is later
// work.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;

__global__ void __launch_bounds__(THREADS)
chunked_scan_kernel(const float* __restrict__ x, const float* __restrict__ decay,
                    const float* __restrict__ h0, float* __restrict__ h_all,
                    float* __restrict__ h_last, int T, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  float h = h0[d];
  long long idx = d;
#pragma unroll 16
  for (int t = 0; t < T; ++t, idx += D) {
    h = __fmaf_rn(decay[idx], h, x[idx]);
    h_all[idx] = h;
  }
  h_last[d] = h;
}

}  // namespace

// Returns the launch's cudaError_t.
extern "C" int chunked_scan_launch(const void* x, const void* decay,
                                   const void* h0, void* h_all, void* h_last,
                                   int T, int D, void* stream) {
  if (D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  chunked_scan_kernel<<<(D + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(decay),
      static_cast<const float*>(h0), static_cast<float*>(h_all),
      static_cast<float*>(h_last), T, D);
  return static_cast<int>(cudaGetLastError());
}
