// Streaming S-DP solver: the blocked pipeline of the paper's Fig. 2 with the
// table's dependency horizon kept on chip, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/sdp_pipeline.py::sdp_chunked_pallas and
//   ::sdp_chunked_pallas_with_args (body: _make_chunked_kernel).
//
// Computes, for every instance b of a batch,
//   ST[i] = (+)_j ST[i - a_j] (.) w[i, j],   ST[0 .. a_1-1] preset,
// finalizing B = min(a_k, block) cells per step, lanes folded in ascending
// j; with args a lane wins only by strict improvement (argmin/argmax's
// first occurrence) and preset cells carry -1.
//
// Window: a cell reads at most a_1 cells back, so the last a_1 finalized
// cells are everything a step needs. They live in a ring of R >= a_1 + B
// floats in shared memory: cell c sits in slot c mod R. A step reads cells
// [s - a_1, s + B - a_k) and writes cells [s, s + B); the span is at most
// a_1 + B <= R, so no slot is read and written in one step, and the ring
// needs no carry copy (the Pallas kernel slides its window instead, which
// overlaps when the chunk is shorter than a_1). Finished cells also go
// straight to the output table in device memory, which is never read.
//
// Weights: the (B, k) rows of a step are contiguous in device memory; the
// CTA stages them J lanes at a time into a shared tile of row stride J | 1
// with coalesced loads (an odd stride keeps a warp's reads of one lane on
// distinct banks), then each thread folds its row from the tile.
//
// Mapping: one CTA per instance (grid = batch), thread t finalizes cell
// s + t of each step, __syncthreads() between steps. The offsets sit in
// shared memory too (broadcast reads).
//
// What bounds it on this card: the steps form a serial chain on one SM, so
// the kernel is bound by each step's latency (k shared-memory reads and a
// dependent min/select per candidate, plus the staged weight load), far
// above the byte bound (table out once, weights in once) and the operation
// bound. Against the K1 kernel (sdp_pipeline.cu), every table read here is
// a shared-memory read instead of an L1/L2/DRAM one.
//
// Built with --fmad=false; the plus-times ring's t*w and the fold's adds use
// __fmul_rn/__fadd_rn and round like the plain PyTorch version's.
#include <cuda_runtime.h>

namespace {

constexpr int OP_MIN = 0;
constexpr int OP_MAX = 1;
constexpr int OP_ADD = 2;

template <int OP>
__device__ __forceinline__ float semiring_mul(float t, float w) {
  return OP == OP_ADD ? __fmul_rn(t, w) : __fadd_rn(t, w);
}

// Fold candidate v of lane j into (acc, arg); lane 0 seeds the fold.
template <int OP>
__device__ __forceinline__ void fold(float v, int j, float& acc, int& arg) {
  if (j == 0) {
    acc = v;
  } else if (OP == OP_ADD) {
    acc = __fadd_rn(acc, v);
  } else if (OP == OP_MIN ? (v < acc) : (v > acc)) {
    acc = v;
    arg = j;
  }
}

template <int OP, bool WEIGHTED, bool ARGS>
__global__ void sdp_chunked_kernel(const float* __restrict__ init,
                                   const float* __restrict__ weights,
                                   const int* __restrict__ offsets,
                                   float* __restrict__ out,
                                   int* __restrict__ args, int n, int a1,
                                   int k, int B, int R, int J) {
  extern __shared__ float smem[];
  float* ring = smem;                                  // R cells
  int* offs = reinterpret_cast<int*>(smem + R);        // k offsets
  float* wt = smem + R + k;                            // B x (J | 1) weights
  const int JS = J | 1;
  const long long b = blockIdx.x;
  float* st = out + b * n;
  int* ar = ARGS ? args + b * n : nullptr;
  const float* w = WEIGHTED ? weights + b * (long long)n * k : nullptr;
  const int t = threadIdx.x;
  for (int i = t; i < a1; i += blockDim.x) {
    const float v = init[b * a1 + i];
    ring[i] = v;
    st[i] = v;
    if (ARGS) ar[i] = -1;
  }
  for (int j = t; j < k; j += blockDim.x) offs[j] = offsets[j];
  __syncthreads();

  int base = a1;                  // ring slot of the step's first cell s
  for (int s = a1; s < n; s += B) {
    const int cnt = min(B, n - s);
    const bool live = t < cnt;
    int slot = base + t;          // base < R and t < B <= R - a1
    if (slot >= R) slot -= R;
    float acc = 0.0f;
    int arg = 0;
    if (!WEIGHTED) {
      if (live) {
        for (int j = 0; j < k; ++j) {
          int idx = slot - offs[j];
          if (idx < 0) idx += R;
          fold<OP>(ring[idx], j, acc, arg);
        }
      }
    } else {
      const float* wstep = w + (long long)s * k;
      for (int j0 = 0; j0 < k; j0 += J) {
        const int jn = min(J, k - j0);
        for (int q = t; q < cnt * jn; q += blockDim.x) {
          const int r = q / jn, c = q - r * jn;
          wt[r * JS + c] = wstep[(long long)r * k + j0 + c];
        }
        __syncthreads();
        if (live) {
          const float* wrow = wt + t * JS - j0;
          for (int j = j0; j < j0 + jn; ++j) {
            int idx = slot - offs[j];
            if (idx < 0) idx += R;
            fold<OP>(semiring_mul<OP>(ring[idx], wrow[j]), j, acc, arg);
          }
        }
        __syncthreads();          // the tile is refilled next
      }
    }
    if (live) {
      ring[slot] = acc;
      st[s + t] = acc;
      if (ARGS) ar[s + t] = arg;
    }
    // Weighted steps need no barrier here: the next step's staging barrier
    // orders these ring writes before any of its reads.
    if (!WEIGHTED) __syncthreads();
    base += B;
    if (base >= R) base -= R;
  }
}

template <int OP, bool WEIGHTED, bool ARGS>
int launch(const void* init, const void* weights, const void* offsets,
           void* out, void* args, int batch, int n, int a1, int k, int B,
           int R, int J, size_t smem, cudaStream_t stream) {
  auto kernel = sdp_chunked_kernel<OP, WEIGHTED, ARGS>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int threads = ((B + 31) / 32) * 32;
  kernel<<<batch, threads, smem, stream>>>(
      static_cast<const float*>(init), static_cast<const float*>(weights),
      static_cast<const int*>(offsets), static_cast<float*>(out),
      static_cast<int*>(args), n, a1, k, B, R, J);
  return static_cast<int>(cudaGetLastError());
}

template <int OP>
int launch_op(const void* init, const void* weights, const void* offsets,
              void* out, void* args, int batch, int n, int a1, int k, int B,
              int R, int J, size_t smem, cudaStream_t s) {
  if (weights != nullptr) {
    if (args != nullptr)
      return launch<OP, true, true>(init, weights, offsets, out, args, batch,
                                    n, a1, k, B, R, J, smem, s);
    return launch<OP, true, false>(init, weights, offsets, out, args, batch,
                                   n, a1, k, B, R, J, smem, s);
  }
  if (args != nullptr)
    return launch<OP, false, true>(init, weights, offsets, out, args, batch,
                                   n, a1, k, B, R, J, smem, s);
  return launch<OP, false, false>(init, weights, offsets, out, args, batch, n,
                                  a1, k, B, R, J, smem, s);
}

}  // namespace

// init (batch, a1) f32; weights (batch, n, k) f32 or null; offsets (k,)
// int32 on the device; out (batch, n) f32; args (batch, n) int32 or null.
// R: ring length (>= a1 + B); J: weight lanes per staged tile; smem: bytes
// of dynamic shared memory, 4 * (R + k + (weights ? B * (J | 1) : 0)).
// op: 0 = min, 1 = max, 2 = add (no args). Returns a cudaError_t.
extern "C" int sdp_chunked_launch(const void* init, const void* weights,
                                  const void* offsets, void* out, void* args,
                                  int batch, int n, int a1, int k, int B,
                                  int R, int J, int op, long long smem,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  if (op == OP_MIN)
    return launch_op<OP_MIN>(init, weights, offsets, out, args, batch, n, a1,
                             k, B, R, J, bytes, s);
  if (op == OP_MAX)
    return launch_op<OP_MAX>(init, weights, offsets, out, args, batch, n, a1,
                             k, B, R, J, bytes, s);
  if (op == OP_ADD && args == nullptr)
    return launch_op<OP_ADD>(init, weights, offsets, out, args, batch, n, a1,
                             k, B, R, J, bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
