// Tiled triangular solver for the canonical split recurrence (MCM, optimal
// BST, polygon triangulation) with the traceback fused into the same launch,
// hand-written for Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mcm_tiled.py::mcm_tiled_pallas, ::_with_args and
//   ::_fused (body: _make_tiled_kernel).
//
// On the diagonal-major table (off(d) = d*n - d(d-1)/2 is the first cell of
// diagonal d), diagonal d is finished in one pass of tiles:
//   m[off(d)+i] = min_{0<=e<d} ((m[off(e)+i] + m[off(d-e-1)+e+1+i])
//                               + W[off(d)+i, e]),
// the association of the plain wavefront solver; diagonal 0 is preset to 0
// (args -1). Each T-row x E-split tile stages three operands in shared
// memory with coalesced copies:
//   * E left runs  m[off(e) + i0 : +T],
//   * E right runs m[off(d-e-1) + e+1 + i0 : +T],
//   * one T x E weight tile, whose rows are E contiguous floats at row
//     stride n-1, stored at row stride E | 1 (odd: a warp reading one split
//     of T rows touches distinct banks).
// Thread t owns row i0 + t and folds its splits in ascending e with strict
// improvement (argmin's first occurrence), so tables and args are bit-equal
// to the mcm_pipeline kernel and the wavefront route. Rows i >= n - d and
// splits e >= d are not staged and not folded: nothing spills into later
// diagonals, and the table is not padded (the Pallas kernel computes spill
// rows into a padded table instead). Copies are cp.async (4 bytes each, no
// register staging), all started before one wait; a barrier separates the
// diagonals.
//
// Fused: after the last diagonal and a barrier, thread 0 walks the split tree
// in preorder over the args this CTA wrote (a DFS with a stack of n+2 int32
// pairs in shared memory, pushing right then left, as
// core.mcm.triangular_traceback_np) and writes the n-1 nodes (i, d, e) to
// nodes[b] as three rows of n-1 int32.
//
// Mapping: one CTA per instance (grid = batch), T threads.
//
// What bounds it on this card: the weights, ~n^3/6 floats read once (0.72 GB
// at n = 1024), and twice as many table reads, which L2 serves (the table is
// 2.1 MB at n = 1024), all through the one SM that runs the instance. K2
// (mcm_pipeline.cu) reads a weight row per cell, which makes each warp-wide
// load touch 32 sectors; here each warp reads contiguous runs.
//
// Built with --fmad=false and no fast math.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ long long diag_off(long long d, long long n) {
  return d * n - (d * (d - 1)) / 2;
}

// One asynchronous 4-byte copy from device memory into shared memory.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <bool ARGS, bool FUSED>
__global__ void mcm_tiled_kernel(const float* __restrict__ wtab,
                                 float* st_all, int* args_all,
                                 int* nodes_all, int n, int L, int E) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int ES = E | 1;
  float* lbuf = smem;                 // E x T
  float* rbuf = smem + E * T;         // E x T
  float* wbuf = smem + 2 * E * T;     // T x ES
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const long long cells = (long long)n * (n + 1) / 2;
  float* st = st_all + b * cells;
  int* ar = ARGS ? args_all + b * cells : nullptr;
  const float* w = wtab + b * cells * L;

  for (int i = tid; i < n; i += T) {
    st[i] = 0.0f;
    if (ARGS) ar[i] = -1;
  }
  __syncthreads();
  for (int d = 1; d < n; ++d) {
    const int rows = n - d;
    const long long off_d = diag_off(d, n);
    for (int i0 = 0; i0 < rows; i0 += T) {
      const int tr = min(T, rows - i0);
      float acc = INFINITY;
      int arg = 0;
      for (int e0 = 0; e0 < d; e0 += E) {
        const int en = min(E, d - e0);
        if (tid < tr) {
          for (int m = 0; m < en; ++m) {
            const int e = e0 + m;
            copy_async(lbuf + m * T + tid, st + diag_off(e, n) + i0 + tid);
            copy_async(rbuf + m * T + tid,
                       st + diag_off(d - e - 1, n) + e + 1 + i0 + tid);
          }
        }
        for (int q = tid; q < tr * en; q += T) {
          const int r = q / en, c = q - r * en;
          copy_async(wbuf + r * ES + c, w + (off_d + i0 + r) * L + e0 + c);
        }
        wait_copies();
        __syncthreads();
        if (tid < tr) {
          for (int m = 0; m < en; ++m) {
            const float v = __fadd_rn(
                __fadd_rn(lbuf[m * T + tid], rbuf[m * T + tid]),
                wbuf[tid * ES + m]);
            if (v < acc) {
              acc = v;
              arg = e0 + m;
            }
          }
        }
        __syncthreads();              // the tiles are refilled next
      }
      if (tid < tr) {
        st[off_d + i0 + tid] = acc;
        if (ARGS) ar[off_d + i0 + tid] = arg;
      }
    }
    __syncthreads();                  // diagonal d is read from d + 1 on
  }

  if (FUSED && tid == 0) {
    int* si = reinterpret_cast<int*>(smem);
    int* sd = si + n + 2;
    int* nodes = nodes_all + b * 3 * (long long)L;
    si[0] = 0;
    sd[0] = n - 1;
    int sp = 1;
    for (int t = 0; t < n - 1; ++t) {
      const int top = max(sp - 1, 0);
      const int i = si[top], dd = sd[top];
      const long long c =
          min(max(diag_off(dd, n) + i, 0LL), cells - 1);
      const int e = min(max(ar[c], 0), max(dd - 1, 0));
      sp = top;
      const int rd = dd - e - 1;
      if (rd >= 1) {                  // right child first: the left pops next
        si[sp] = i + e + 1;
        sd[sp] = rd;
        ++sp;
      }
      if (e >= 1) {
        si[sp] = i;
        sd[sp] = e;
        ++sp;
      }
      nodes[t] = i;
      nodes[L + t] = dd;
      nodes[2 * L + t] = e;
    }
  }
}

template <bool ARGS, bool FUSED>
int launch(const void* wtab, void* st, void* args, void* nodes, int batch,
           int n, int L, int T, int E, size_t smem, cudaStream_t s) {
  auto kernel = mcm_tiled_kernel<ARGS, FUSED>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<batch, T, smem, s>>>(static_cast<const float*>(wtab),
                                static_cast<float*>(st),
                                static_cast<int*>(args),
                                static_cast<int*>(nodes), n, L, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wtab (batch, n(n+1)/2, L) f32 with L = max(n-1, 1); st (batch, cells) f32;
// args (batch, cells) int32 or null; nodes (batch, 3, L) int32 or null (only
// with args). T rows per tile = threads per CTA, E splits per tile; smem:
// bytes of dynamic shared memory, the larger of 4 * (2*E*T + T*(E|1)) and,
// with nodes, 8 * (n + 2). Returns a cudaError_t.
extern "C" int mcm_tiled_launch(const void* wtab, void* st, void* args,
                                void* nodes, int batch, int n, int L, int T,
                                int E, long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  if (nodes != nullptr) {
    if (args == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch<true, true>(wtab, st, args, nodes, batch, n, L, T, E, bytes,
                              s);
  }
  if (args != nullptr)
    return launch<true, false>(wtab, st, args, nullptr, batch, n, L, T, E,
                               bytes, s);
  return launch<false, false>(wtab, st, nullptr, nullptr, batch, n, L, T, E,
                              bytes, s);
}
