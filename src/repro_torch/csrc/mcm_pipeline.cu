// Diagonal pipeline for the canonical triangular split recurrence (MCM,
// optimal BST, polygon triangulation), hand-written for Hopper: each
// instance runs on a thread-block cluster, its cost table resident in
// shared memory.
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
// Mapping. One cluster of C CTAs per instance (C from the wrapper: the
// largest size of which the card keeps the whole batch resident, asked of
// the occupancy API). Instances are independent clusters, so any batch
// runs, in waves if it must. The table's home (table_in_smem, mirrored by
// kernels/mcm_pipeline.py::table_home):
//   * shared memory, when the n(n+1)/2 floats fit beside the merge slots
//     (every n <= 340; the L2 gate sends K2 n <= 295): each CTA keeps a
//     replica, and every finished cell is written into every replica
//     through distributed shared memory (DSMEM);
//   * device memory past that: the output table itself, read past L1
//     (ld.global.cg), since other SMs of the cluster wrote it.
// Each diagonal's cells are dealt out to groups of w lanes (w =
// lanes_per_cell(d): the least power of two covering the d splits, halved
// while the cells would not each get a group), consecutive cells to
// consecutive CTAs. One cluster barrier (arrive.release / wait.acquire)
// separates the diagonals.
//
// Fold. Lane t of a group takes the splits e = t, t + w, ... in ascending
// order with strict improvement; the group then merges by value and, on
// equal values, the smaller split (shuffles in a warp, a shared-memory slot
// per warp across warps): the first best split, the sequential fold's arg,
// and its bits (signed zeros included). An all-inf row keeps arg 0. The
// weight row W[off(d)+t, 0:d] is contiguous, so a group's weight reads
// coalesce; the first PF weights of a thread's first cell on the next
// diagonal are loaded into registers (streaming, ld.global.cs) before the
// barrier. Finished tables leave shared memory once, each CTA storing a
// share of the cells, coalesced; args are stored as they are produced.
//
// What bounds it on this card: the byte bound is the weights, ~n^3/6
// floats read once (89.5 MB for 8 x 256; 0.72 GB at n = 1024), at 3.35
// TB/s. The time is the chain of n - 1 diagonals: each pays a fixed cost
// (the cluster barrier, the merge, the replica writes; ~1.6 us on an H100
// with no fold and no weights, PERF.md) and one round trip for its
// weights. With the table in device memory (n > 340) every operand read is
// a scattered L2 access: a group's lanes read cells of different
// diagonals.
//
// Built with --fmad=false and no fast math.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int THREADS = 512;          // 16 warps a CTA
constexpr int WARPS = THREADS / 32;
constexpr int PF = 8;                 // weights a thread loads ahead / per batch
constexpr int NO_ARG = 0x7fffffff;
constexpr int MAX_CLUSTER = 16;       // non-portable above 8
// shared memory a block can opt into on sm_90a (_build.SMEM_OPTIN_BYTES)
constexpr long long SMEM_OPTIN = 232448;
constexpr long long MERGE_BYTES = 8 * WARPS;   // a (value, split) pair a warp

template <class Off>
__device__ __forceinline__ Off diag_off(Off d, Off n) {
  return d * n - (d * (d - 1)) / 2;
}

// The table's bytes in shared memory, padded to 16.
__host__ __device__ __forceinline__ long long table_bytes(long long n) {
  return (4 * (n * (n + 1) / 2) + 15) / 16 * 16;
}

// Whether an instance's table lives in shared memory (else device memory).
// Mirrored by kernels/mcm_pipeline.py::table_home.
__host__ __device__ __forceinline__ bool table_in_smem(long long n) {
  return table_bytes(n) + MERGE_BYTES <= SMEM_OPTIN;
}

long long smem_bytes(int n) {
  return (table_in_smem(n) ? table_bytes(n) : 0) + MERGE_BYTES;
}

// Lanes folding one cell of diagonal d (cells_d cells, `lanes` threads in
// the cluster): the least power of two covering the d splits, at most
// THREADS, halved while the cells would not each get a group. Mirrored by
// kernels/mcm_pipeline.py::lanes_per_cell.
__device__ __forceinline__ int lanes_per_cell(int d, int cells_d, int lanes) {
  int w = 1;
  while (w < THREADS && w < d) w *= 2;
  while (w > 1 && (long long)cells_d * w > lanes) w /= 2;
  return w;
}

// (value, split) of a or b, whichever is smaller, the smaller split on ties
__device__ __forceinline__ void merge(float& v, int& e, float ov, int oe) {
  if (ov < v || (ov == v && oe < e)) {
    v = ov;
    e = oe;
  }
}

// ---- device primitives
__device__ __forceinline__ int cluster_rank() {
  return static_cast<int>(cooperative_groups::this_cluster().block_rank());
}

// Cell c of CTA q's replica (DSMEM for another CTA of the cluster).
__device__ __forceinline__ float* replica(float* tab, long long c, int q) {
  return cooperative_groups::this_cluster().map_shared_rank(tab + c, q);
}

// The cluster's barrier with release / acquire semantics: every write
// before it (shared memory of any CTA of the cluster, device memory) is
// seen by every thread of the cluster after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// ---- end of device primitives ----

__device__ __forceinline__ void step_barrier(int C) {
  if (C > 1)
    cluster_barrier();
  else
    __syncthreads();
}

template <bool ARGS, bool SMEM>
__global__ void __launch_bounds__(THREADS, 1)
mcm_pipeline_kernel(const float* __restrict__ wtab, float* st_all, int* args_all,
                    int n, int L, int C) {
  // cell offsets: 32-bit within a shared-memory table (n <= 340)
  using Off = typename std::conditional<SMEM, int, long long>::type;
  extern __shared__ __align__(16) float smem[];
  float* tab = smem;                                        // SMEM: the replica
  float* mv = smem + (SMEM ? table_bytes(n) / 4 : 0);       // WARPS values
  int* me = reinterpret_cast<int*>(mv + WARPS);             // WARPS splits
  const int rank = C > 1 ? cluster_rank() : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lanes = C * THREADS;                            // the instance's threads
  const long long b = blockIdx.x / C;
  const long long cells = (long long)n * (n + 1) / 2;
  float* st = st_all + b * cells;
  int* ar = ARGS ? args_all + b * cells : nullptr;
  const float* w = wtab + b * cells * L;

  for (int i = tid; i < n; i += THREADS) {                  // diagonal 0
    if (SMEM) tab[i] = 0.0f;
    if (rank == 0) {
      if (!SMEM) st[i] = 0.0f;
      if (ARGS) ar[i] = -1;
    }
  }

  // diagonal d's deal: groups of wd = 2^lw lanes, this thread's first cell
  // q0 and lane t in its group, groups of the cluster
  struct Deal {
    int wd, lw, q0, t, groups;
  };
  auto deal = [&](int d) {
    Deal g;
    g.wd = lanes_per_cell(d, n - d, lanes);
    g.lw = 31 - __clz(g.wd);
    g.q0 = (tid >> g.lw) * C + rank;
    g.t = tid & (g.wd - 1);
    g.groups = (THREADS >> g.lw) * C;
    return g;
  };
  // the weights of this thread's first cell on diagonal d, ahead of time
  float wpf[PF];
  auto prefetch = [&](int d) {
    const Deal g = deal(d);
#pragma unroll
    for (int u = 0; u < PF; ++u) wpf[u] = 0.0f;
    if (g.q0 < n - d) {
      const float* wr = w + (diag_off<long long>(d, n) + g.q0) * L;
#pragma unroll
      for (int u = 0; u < PF; ++u) {
        const int e = g.t + u * g.wd;
        if (e < d) wpf[u] = __ldcs(wr + e);
      }
    }
  };
  if (n > 1) prefetch(1);
  step_barrier(C);      // every CTA of the cluster runs before DSMEM writes

  for (int d = 1; d < n; ++d) {
    const int cd = n - d;
    const Off off_d = diag_off<Off>(d, n);
    const Deal g = deal(d);
    const int wd = g.wd, t = g.t;
    const int rounds = (cd + g.groups - 1) / g.groups;
    for (int r = 0; r < rounds; ++r) {
      const int q = g.q0 + r * g.groups;
      float best = INFINITY;
      int arg = NO_ARG;
      if (q < cd) {
        const float* wr = w + ((long long)off_d + q) * L;
        bool ahead = r == 0;
        for (int e0 = t; e0 < d; e0 += PF * wd) {
          float a[PF], c[PF], wv[PF];
#pragma unroll
          for (int u = 0; u < PF; ++u) {
            const int e = e0 + u * wd;
            if (e < d) {
              const Off lo = diag_off<Off>(e, n) + q;
              const Off ro = diag_off<Off>(d - e - 1, n) + e + 1 + q;
              a[u] = SMEM ? tab[lo] : __ldcg(st + lo);
              c[u] = SMEM ? tab[ro] : __ldcg(st + ro);
              wv[u] = ahead ? wpf[u] : __ldcs(wr + e);
            }
          }
          ahead = false;
#pragma unroll
          for (int u = 0; u < PF; ++u) {
            const int e = e0 + u * wd;
            if (e < d) {
              const float v = __fadd_rn(__fadd_rn(a[u], c[u]), wv[u]);
              if (v < best) {
                best = v;
                arg = e;
              }
            }
          }
        }
      }
      // the group's merge: a butterfly over its lanes (all of the warp's
      // when it spans warps), then across its warps; every lane ends with
      // the group's (value, split)
      for (int s = (wd < 32 ? wd : 32) / 2; s > 0; s >>= 1)
        merge(best, arg, __shfl_xor_sync(0xffffffffu, best, s),
              __shfl_xor_sync(0xffffffffu, arg, s));
      if (wd > 32) {                               // uniform over the cluster
        if (lane == 0) {
          mv[warp] = best;
          me[warp] = arg;
        }
        __syncthreads();
        const int gw = wd / 32, w0 = warp - warp % gw;
        for (int k = 0; k < gw; ++k) merge(best, arg, mv[w0 + k], me[w0 + k]);
        __syncthreads();                           // mv / me are refilled next
      }
      if (q < cd) {
        const Off c0 = off_d + q;
        if (SMEM) {
          for (int k = t; k < C; k += wd) {
            if (C > 1)
              *replica(tab, c0, k) = best;
            else
              tab[c0] = best;
          }
        } else if (t == 0) {
          st[c0] = best;
        }
        if (ARGS && t == 0) ar[c0] = arg == NO_ARG ? 0 : arg;
      }
    }
    if (d + 1 < n) prefetch(d + 1);
    step_barrier(C);                               // diagonal d is read from d + 1 on
  }

  if (SMEM)                                        // the table out, a share a CTA
    for (long long c = (long long)rank * THREADS + tid; c < cells; c += lanes)
      st[c] = tab[c];
}

using Kernel = void (*)(const float*, float*, int*, int, int, int);

Kernel pick(bool with_args, bool smem) {
  if (smem) return with_args ? mcm_pipeline_kernel<true, true> : mcm_pipeline_kernel<false, true>;
  return with_args ? mcm_pipeline_kernel<true, false> : mcm_pipeline_kernel<false, false>;
}

cudaError_t configure(Kernel kernel, long long smem) {
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t config(int grid, long long smem, int C, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;        // a cluster of one CTA too: the occupancy query needs it
  return cfg;
}

}  // namespace

// Threads a CTA (the wrapper's lane rule reads it).
extern "C" int mcm_pipeline_threads() { return THREADS; }

// 1 if an instance of width n keeps its table in shared memory, else 0.
extern "C" int mcm_pipeline_table_in_smem(int n) { return table_in_smem(n) ? 1 : 0; }

// Dynamic shared memory of one CTA at width n.
extern "C" long long mcm_pipeline_smem_bytes(int n) { return smem_bytes(n); }

// How many clusters of C CTAs of the variant (with_args, width n) the card
// can run at once (cudaOccupancyMaxActiveClusters); 0 if none, or if it
// refuses the query.
extern "C" int mcm_pipeline_max_clusters(int with_args, int n, int C) {
  if (C < 1 || C > MAX_CLUSTER) return 0;
  const long long smem = smem_bytes(n);
  Kernel kernel = pick(with_args != 0, table_in_smem(n));
  if (configure(kernel, smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(C, smem, C, 0, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel),
                                     &cfg) != cudaSuccess) {
    cudaGetLastError();  // a refused query leaves no error behind
    return 0;
  }
  return clusters;
}

// wtab (batch, n(n+1)/2, L) f32 with L = max(n-1, 1); st (batch, cells) f32;
// args (batch, cells) int32 or null; C CTAs per instance (1..16). Returns
// a cudaError_t.
extern "C" int mcm_pipeline_launch(const void* wtab, void* st, void* args,
                                   int batch, int n, int L, int C, void* stream) {
  if (C < 1 || C > MAX_CLUSTER) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(n);
  Kernel kernel = pick(args != nullptr, table_in_smem(n));
  cudaError_t rc = configure(kernel, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(batch * C, smem, C, static_cast<cudaStream_t>(stream),
                                  &attr);
  const float* w = static_cast<const float*>(wtab);
  float* s = static_cast<float*>(st);
  int* a = static_cast<int*>(args);
  void* params[] = {&w, &s, &a, &n, &L, &C};
  rc = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), params);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
