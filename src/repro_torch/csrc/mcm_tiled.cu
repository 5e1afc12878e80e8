// Triangular solver for the canonical split recurrence (MCM, optimal BST,
// polygon triangulation) with the traceback fused into the same launch,
// hand-written for Hopper: one persistent launch spreads every diagonal
// over the whole card.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mcm_tiled.py::mcm_tiled_pallas, ::_with_args and
//   ::_fused (body: _make_tiled_kernel).
//
// On the diagonal-major table (off(d) = d*n - d(d-1)/2 is the first cell of
// diagonal d), cell (i, d) of diagonal d >= 1 is
//   m[off(d)+i] = min_{0<=e<d} ((m[off(e)+i] + m[off(d-e-1)+e+1+i])
//                               + W[off(d)+i, e]),
// the association of the plain wavefront solver; diagonal 0 is preset to 0
// (args -1).
//
// Mapping. The grid holds as many CTAs as the card can keep resident (the
// wrapper asks the occupancy API; the launch is cooperative, so a grid
// that cannot be co-resident is refused, never left to hang). Each
// diagonal's cells, over all instances of the batch, are dealt out to
// groups of g warps (g = warps_per_cell(d), uniform over the grid: as many
// warps as the splits fill, as long as every cell still gets a group),
// consecutive cells to consecutive CTAs. A grid-wide barrier (an arrival
// counter in device memory, release / acquire) separates the diagonals.
//
// Fold. Thread t of a group takes the splits e = t, t + 32g, ... in
// ascending order with strict improvement, then the group merges by value
// and, on equal values, the smaller split: the first best split, the
// sequential fold's arg, and its bits (signed zeros included). An all-inf
// row keeps arg 0. A cell's fold never leaves its CTA. Every operand is
// read contiguously across a warp:
//   * W[off(d)+i, e] is contiguous in e;
//   * the left operand, cell (i, i+e), comes from a row-major n x n copy
//     of the finished table (row i contiguous in the end point);
//   * the right operand, cell (i+e+1, i+d), from a column-major copy
//     (column i+d contiguous in the start point).
// Each finished cell goes to the table and to both copies (scratch the
// wrapper allocates: 8 MiB at n = 1024, which L2 holds). Cells written
// before a barrier are read past L1 (ld.global.cg), where no SM keeps a
// stale line. Weights are streamed (ld.global.cs); the first four of a
// thread's next-diagonal weights are loaded into registers before it
// waits at the barrier, so their latency leaves the serial chain.
//
// Fused: after the last barrier, thread 0 of CTA b walks instance b's
// split tree in preorder over the args (a DFS with a stack of n+2 int32
// pairs in shared memory, pushing right then left, as
// core.mcm.triangular_traceback_np) and writes the n-1 nodes (i, d, e) to
// nodes[b] as three rows of n-1 int32.
//
// What bounds it on this card: the weights, ~n^3/6 floats read once (0.72
// GB at n = 1024, 0.21 ms at 3.35 TB/s), and twice as many table reads
// from L2; then the n - 1 barriers of the diagonal chain, each a round
// trip through L2.
//
// Built with --fmad=false and no fast math.
#include <cuda_runtime.h>
#include <math.h>

#include "grid_sync.cuh"

namespace {

constexpr int THREADS = 512;          // 16 warps a CTA
constexpr int WARPS = THREADS / 32;
constexpr int PF = 4;                 // weights a thread loads ahead / per batch
constexpr int NO_ARG = 0x7fffffff;

__device__ __forceinline__ long long diag_off(long long d, long long n) {
  return d * n - (d * (d - 1)) / 2;
}

// Warps folding one cell of diagonal d: the least power of two whose lanes
// cover the d splits, at most WARPS, halved while the cells would not each
// get a group. Mirrored by kernels/mcm_tiled.py::warps_per_cell.
__device__ __forceinline__ int warps_per_cell(int d, long long cells_d, int G) {
  int g = 1;
  while (g < WARPS && 32 * g < d) g *= 2;
  while (g > 1 && cells_d * g > (long long)G * WARPS) g /= 2;
  return g;
}

// (value, split) of a or b, whichever is smaller, the smaller split on ties
__device__ __forceinline__ void merge(float& v, int& e, float ov, int oe) {
  if (ov < v || (ov == v && oe < e)) {
    v = ov;
    e = oe;
  }
}

template <bool ARGS, bool FUSED>
__global__ void __launch_bounds__(THREADS, 1)
mcm_tiled_kernel(const float* __restrict__ wtab, float* st_all, int* args_all,
                  int* nodes_all, float* rowm, float* colm, unsigned* bar,
                  int batch, int n, int L) {
  extern __shared__ int smem[];
  float* mv = reinterpret_cast<float*>(smem);   // WARPS partial values
  int* me = smem + WARPS;                       // WARPS partial splits
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = gridDim.x;
  const long long cells = (long long)n * (n + 1) / 2;
  const long long nn = (long long)n * n;

  // diagonal 0: the table, the args and both copies' diagonals
  for (long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
       q < (long long)batch * n; q += (long long)G * THREADS) {
    const long long b = q / n, i = q - b * n;
    st_all[b * cells + i] = 0.0f;
    if (ARGS) args_all[b * cells + i] = -1;
    rowm[b * nn + i * n + i] = 0.0f;
    colm[b * nn + i * n + i] = 0.0f;
  }

  // the weights of this thread's first cell on diagonal d, ahead of time
  float wpf[PF];
  auto prefetch = [&](int d) {
    const long long rows = n - d, cd = (long long)batch * rows;
    const int g = warps_per_cell(d, cd, G);
    const long long q = (long long)(warp / g) * G + blockIdx.x;
    const int t = (warp % g) * 32 + lane;
#pragma unroll
    for (int u = 0; u < PF; ++u) wpf[u] = 0.0f;
    if (q < cd) {
      const long long b = q / rows, i = q - b * rows;
      const float* wr = wtab + (b * cells + diag_off(d, n) + i) * L;
#pragma unroll
      for (int u = 0; u < PF; ++u) {
        const int e = t + u * 32 * g;
        if (e < d) wpf[u] = __ldcs(wr + e);
      }
    }
  };
  if (n > 1) prefetch(1);
  unsigned phase = 0;
  grid_sync(bar, ++phase);

  for (int d = 1; d < n; ++d) {
    const long long rows = n - d, cd = (long long)batch * rows;
    const long long off_d = diag_off(d, n);
    const int g = warps_per_cell(d, cd, G);
    const int T = 32 * g;                        // threads a cell
    const long long groups = (long long)G * (WARPS / g);
    const long long gid = (long long)(warp / g) * G + blockIdx.x;
    const int t = (warp % g) * 32 + lane;
    const long long rounds = (cd + groups - 1) / groups;
    for (long long r = 0; r < rounds; ++r) {
      const long long q = gid + r * groups;
      float best = INFINITY;
      int arg = NO_ARG;
      long long b = 0, i = 0;
      if (q < cd) {
        b = q / rows;
        i = q - b * rows;
        const float* wr = wtab + (b * cells + off_d + i) * L;
        const float* lr = rowm + b * nn + i * n + i;              // + e
        const float* rr = colm + b * nn + (i + d) * n + i + 1;    // + e
        bool ahead = r == 0;
        for (int e0 = t; e0 < d; e0 += PF * T) {
          float a[PF], c[PF], w[PF];
#pragma unroll
          for (int u = 0; u < PF; ++u) {
            const int e = e0 + u * T;
            if (e < d) {
              a[u] = __ldcg(lr + e);
              c[u] = __ldcg(rr + e);
              w[u] = ahead ? wpf[u] : __ldcs(wr + e);
            }
          }
          ahead = false;
#pragma unroll
          for (int u = 0; u < PF; ++u) {
            const int e = e0 + u * T;
            if (e < d) {
              const float v = __fadd_rn(__fadd_rn(a[u], c[u]), w[u]);
              if (v < best) {
                best = v;
                arg = e;
              }
            }
          }
        }
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        merge(best, arg, __shfl_xor_sync(0xffffffffu, best, s),
              __shfl_xor_sync(0xffffffffu, arg, s));
      if (g > 1) {                               // uniform over the grid
        if (lane == 0) {
          mv[warp] = best;
          me[warp] = arg;
        }
        __syncthreads();
        if (t == 0)
          for (int k = 1; k < g; ++k) merge(best, arg, mv[warp + k], me[warp + k]);
        __syncthreads();                         // mv / me are refilled next
      }
      if (t == 0 && q < cd) {
        const long long c0 = b * cells + off_d + i;
        st_all[c0] = best;
        if (ARGS) args_all[c0] = arg == NO_ARG ? 0 : arg;
        rowm[b * nn + i * n + i + d] = best;
        colm[b * nn + (i + d) * n + i] = best;
      }
    }
    if (d + 1 < n) prefetch(d + 1);
    grid_sync(bar, ++phase);                     // diagonal d is read from d + 1 on
  }

  if (FUSED && threadIdx.x == 0) {
    int* si = smem;
    int* sd = si + n + 2;
    for (long long b = blockIdx.x; b < batch; b += G) {
      const int* ar = args_all + b * cells;
      int* nodes = nodes_all + b * 3 * (long long)L;
      si[0] = 0;
      sd[0] = n - 1;
      int sp = 1;
      for (int t = 0; t < n - 1; ++t) {
        const int top = max(sp - 1, 0);
        const int i = si[top], dd = sd[top];
        const long long c = min(max(diag_off(dd, n) + i, 0LL), cells - 1);
        const int e = min(max(__ldcg(ar + c), 0), max(dd - 1, 0));
        sp = top;
        const int rd = dd - e - 1;
        if (rd >= 1) {                // right child first: the left pops next
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
}

using Kernel = void (*)(const float*, float*, int*, int*, float*, float*,
                        unsigned*, int, int, int);

Kernel pick(int with_args, int fused) {
  if (fused) return mcm_tiled_kernel<true, true>;
  return with_args ? mcm_tiled_kernel<true, false> : mcm_tiled_kernel<false, false>;
}

}  // namespace

// Threads a CTA (the wrapper's plan reads it).
extern "C" int mcm_tiled_threads() { return THREADS; }

// CTAs of the variant (with_args, fused) at `smem` bytes of dynamic shared
// memory that one SM keeps resident at once (occupancy API), or 0 if the
// card refuses the query.
extern "C" int mcm_tiled_blocks_per_sm(int with_args, int fused, long long smem) {
  Kernel kernel = pick(with_args, fused);
  int per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    (size_t)smem) != cudaSuccess)
    return 0;
  return per_sm;
}

// wtab (batch, n(n+1)/2, L) f32 with L = max(n-1, 1); st (batch, cells) f32;
// args (batch, cells) int32 or null; nodes (batch, 3, L) int32 or null (only
// with args); rowm, colm (batch, n, n) f32 scratch; bar one uint32, zero.
// ctas: the grid (at most mcm_tiled_blocks_per_sm x SMs); smem: dynamic shared memory,
// the larger of 8 * WARPS and, with nodes, 8 * (n + 2). A cooperative
// launch: a grid the card cannot keep resident is refused
// (cudaErrorCooperativeLaunchTooLarge). Returns a cudaError_t.
extern "C" int mcm_tiled_launch(const void* wtab, void* st, void* args,
                                void* nodes, void* rowm, void* colm, void* bar,
                                int batch, int n, int L, int ctas,
                                long long smem, void* stream) {
  if (nodes != nullptr && args == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Kernel kernel = pick(args != nullptr, nodes != nullptr);
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const float* w = static_cast<const float*>(wtab);
  float* s = static_cast<float*>(st);
  int* a = static_cast<int*>(args);
  int* nd = static_cast<int*>(nodes);
  float* rm = static_cast<float*>(rowm);
  float* cm = static_cast<float*>(colm);
  unsigned* b = static_cast<unsigned*>(bar);
  void* params[] = {&w, &s, &a, &nd, &rm, &cm, &b, &batch, &n, &L};
  rc = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(ctas),
                                   dim3(THREADS), params, (size_t)smem,
                                   static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
