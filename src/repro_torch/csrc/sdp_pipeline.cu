// Blocked pipelined S-DP solver (the paper's Fig. 2), hand-written for Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/sdp_pipeline.py::sdp_pipeline_pallas and
//   ::sdp_pipeline_pallas_with_args (body: _make_kernel).
//
// Computes, for every instance b of a batch,
//   ST[i] = (+)_j ST[i - a_j] (.) w[i, j],   ST[0 .. a_1-1] preset,
// finalizing B = min(a_k, block) cells per step: every read of block
// [start, start+B) uses an offset >= a_k >= B, so it touches only cells of
// earlier steps. Lanes fold in ascending j; with args, a lane wins only by
// strict improvement (the first-occurrence tie rule of argmin/argmax), and
// preset cells carry -1.
//
// Mapping: one CTA per instance (grid = batch), thread t finalizes cell
// start + t of the current step, __syncthreads() between steps. Reads for a
// fixed j are contiguous across the threads of a warp.
//
// What bounds it on this card: the steps are a serial chain, and one CTA
// runs on one of the 132 SMs. At the paper's size (n = 2^20, k = 2^10) each
// thread runs k dependent min/select steps per block with an L1/L2 load
// each, so the kernel is bound by that latency chain, far above both the
// byte bound (the table is 4 MB) and the operation bound (n*k min ops).
// The table does not fit the 227 KB of shared memory a block can use, so
// it stays in device memory, where L2 (50 MB) holds it; cells past n are
// masked, not padded. Staging a window of the table in shared memory and
// spreading a batch (or one long instance) over more SMs is later work.
//
// Built with --fmad=false and no fast math: the plus-times ring's t*w and
// the fold's adds round like the plain PyTorch version's.
#include <cuda_runtime.h>

namespace {

constexpr int OP_MIN = 0;
constexpr int OP_MAX = 1;
constexpr int OP_ADD = 2;

template <int OP>
__device__ __forceinline__ float semiring_mul(float t, float w) {
  return OP == OP_ADD ? __fmul_rn(t, w) : __fadd_rn(t, w);
}

template <int OP, bool WEIGHTED, bool ARGS>
__global__ void sdp_pipeline_kernel(const float* __restrict__ init,
                                    const float* __restrict__ weights,
                                    const int* __restrict__ offsets,
                                    float* out, int* args, int n, int a1,
                                    int k, int B, int num_blocks) {
  const long long b = blockIdx.x;
  float* st = out + b * n;
  int* ar = ARGS ? args + b * n : nullptr;
  const float* w = WEIGHTED ? weights + b * (long long)n * k : nullptr;
  for (int i = threadIdx.x; i < a1; i += blockDim.x) {
    st[i] = init[b * a1 + i];
    if (ARGS) ar[i] = -1;
  }
  __syncthreads();
  const int t = threadIdx.x;
  for (int blk = 0; blk < num_blocks; ++blk) {
    const int pos = a1 + blk * B + t;
    if (t < B && pos < n) {
      const float* wrow = WEIGHTED ? w + (long long)pos * k : nullptr;
      float acc = st[pos - offsets[0]];
      if (WEIGHTED) acc = semiring_mul<OP>(acc, wrow[0]);
      int arg = 0;
      for (int j = 1; j < k; ++j) {
        float v = st[pos - offsets[j]];
        if (WEIGHTED) v = semiring_mul<OP>(v, wrow[j]);
        if (OP == OP_ADD) {
          acc = __fadd_rn(acc, v);
        } else if (OP == OP_MIN ? (v < acc) : (v > acc)) {
          acc = v;
          arg = j;
        }
      }
      st[pos] = acc;
      if (ARGS) ar[pos] = arg;
    }
    __syncthreads();
  }
}

template <int OP, bool WEIGHTED, bool ARGS>
void launch(const void* init, const void* weights, const void* offsets,
            void* out, void* args, int batch, int n, int a1, int k, int B,
            int num_blocks, cudaStream_t stream) {
  const int threads = ((B + 31) / 32) * 32;
  sdp_pipeline_kernel<OP, WEIGHTED, ARGS><<<batch, threads, 0, stream>>>(
      static_cast<const float*>(init), static_cast<const float*>(weights),
      static_cast<const int*>(offsets), static_cast<float*>(out),
      static_cast<int*>(args), n, a1, k, B, num_blocks);
}

template <int OP>
void launch_op(const void* init, const void* weights, const void* offsets,
               void* out, void* args, int batch, int n, int a1, int k, int B,
               int num_blocks, cudaStream_t stream) {
  if (weights != nullptr) {
    if (args != nullptr)
      launch<OP, true, true>(init, weights, offsets, out, args, batch, n, a1,
                             k, B, num_blocks, stream);
    else
      launch<OP, true, false>(init, weights, offsets, out, args, batch, n, a1,
                              k, B, num_blocks, stream);
  } else {
    if (args != nullptr)
      launch<OP, false, true>(init, weights, offsets, out, args, batch, n, a1,
                              k, B, num_blocks, stream);
    else
      launch<OP, false, false>(init, weights, offsets, out, args, batch, n,
                               a1, k, B, num_blocks, stream);
  }
}

}  // namespace

// init (batch, a1) f32; weights (batch, n, k) f32 or null; offsets (k,)
// int32 on the device; out (batch, n) f32; args (batch, n) int32 or null.
// op: 0 = min, 1 = max, 2 = add (no args). Returns cudaGetLastError().
extern "C" int sdp_pipeline_launch(const void* init, const void* weights,
                                   const void* offsets, void* out, void* args,
                                   int batch, int n, int a1, int k, int B,
                                   int num_blocks, int op, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == OP_MIN)
    launch_op<OP_MIN>(init, weights, offsets, out, args, batch, n, a1, k, B,
                      num_blocks, s);
  else if (op == OP_MAX)
    launch_op<OP_MAX>(init, weights, offsets, out, args, batch, n, a1, k, B,
                      num_blocks, s);
  else if (op == OP_ADD && args == nullptr)
    launch_op<OP_ADD>(init, weights, offsets, out, args, batch, n, a1, k, B,
                      num_blocks, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
