// The chunk walk of the S-DP recurrence, shared by K1 (sdp_pipeline.cu) and
// K3 (sdp_chunked.cu).
//
//   ST[i] = (+)_j ST[i - a_j] (.) w[i, j],   ST[0 .. a_1-1] preset,
//
// lanes folded in ascending j (offsets descend), a lane winning only by
// strict improvement (argmin/argmax's first occurrence), presets carrying
// -1. The walk covers the cells past the presets in chunks of Q cells.
//
// Far lanes. For the cell at position p of a chunk, every lane with
// a_j > p reads a cell of an earlier chunk. Offsets descend, so these lanes
// are a prefix of j. The CTA folds that prefix for all cells of the chunk
// in parallel, S threads per cell (S lane blocks, min and max only). The
// offsets come as maximal runs of consecutive values, (a0, j0, len), so a
// run's sources are consecutive cells: loads with immediate offsets,
// issued four ahead of their compares, and no offset load per candidate.
// For min and max the four candidates go to four accumulators, each the
// strict-improve fold of its lanes, and accumulators and lane blocks merge
// by (value, then lane): the first lane attaining the best value, which is
// what the sequential fold keeps. add folds strictly in order into one
// accumulator, seeded with -0.0 (x + -0.0 == x, bit for bit).
//
// Near lanes (a_j <= p) read cells of the same chunk. They are folded
// afterwards, in ascending source order, which is ascending j, so each
// cell's fold is the sequential one split at a lane boundary:
//   near == 1: the only near offset is 1 (edit_distance, lcs): warp 0
//              walks the chunk 32 cells at a time, every lane running the
//              one chain of add, compare and select;
//   near == 2: near offsets up to 63 (viterbi, knapsack): warp 0 holds the
//              next 64 cells, two a lane; each finished cell is broadcast
//              with a shuffle and folded into every held cell that reads
//              it.
// Neither uses a block barrier; the chain of one cell is one fold (plus a
// shuffle for near == 2), the rest issued around it.
//
// Weights (weighted specs): the chunk's rows are staged into shared memory
// with 4-byte cp.async copies one chunk ahead, into the other half of a
// double buffer, with row stride k | 1 (a warp's reads of one lane fall on
// distinct banks). Where the planner cannot fit them, rows are read from
// device memory directly.
//
// The table: K3 keeps the last a_1 + Q cells in a shared-memory ring of
// R >= a_1 + Q slots (RING), so a chunk's reads [s - a_1, s) and writes
// [s, s + Q) never share a slot; K1 reads and writes the table in device
// memory, where L1 and L2 hold the window. Finished cells go to the table
// (and args) in device memory with coalesced stores.
//
// Clusters (C > 1, all lanes far): the C CTAs of one instance each finish
// Q / C cells of every chunk; one cluster barrier (arrive.release /
// wait.acquire) ends each chunk. K3's CTAs keep a replica of the ring each
// and write every finished cell into every replica through distributed
// shared memory; K1's write the table, and read it past L1.
//
// Built with --fmad=false; products and sums use __fmul_rn / __fadd_rn and
// round like the plain PyTorch versions.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace sdp_walk {

constexpr int OP_MIN = 0;
constexpr int OP_MAX = 1;
constexpr int OP_ADD = 2;
// arg of an accumulator no lane has entered by strict improvement
constexpr int NO_ARG = 0x7fffffff;
// cells the near warp holds, and so the largest near offset + 1
constexpr int WINDOW = 64;
constexpr int MAX_CLUSTER = 8;

struct Args {
  const float* init;     // (batch, a1)
  const float* weights;  // (batch, n, k) or null
  const int4* runs;      // nruns x (a0, j0, len, 0), a0 descending
  float* out;            // (batch, n)
  int* args;             // (batch, n) or null
  int n, a1, k, nruns;
  int Q;      // cells per chunk
  int R;      // ring slots (K3); unused by K1
  int near;   // 0: every lane far; 1: offset 1 only; 2: the warp window
  int stage;  // weights staged in shared memory
  int C;      // CTAs per instance (the cluster size)
  int S;      // threads per cell, each folding a block of far lanes (min/max)
};

// Shared-memory layout, in 4-byte words: ring, the weight double buffer,
// the chunk's partial (acc, arg) and the near lane table, and with lane
// splits the splits' (acc, arg).
__host__ __device__ inline int chunk_per_cta(const Args& a) {
  return (a.Q + a.C - 1) / a.C;
}
__host__ __device__ inline int split_stride(const Args& a) {  // threads a split
  return (chunk_per_cta(a) + 31) / 32 * 32;
}
__host__ __device__ inline long long smem_words(const Args& a, bool ring) {
  long long w = ring ? a.R : 0;
  if (a.stage) w += 2LL * chunk_per_cta(a) * (a.k | 1);
  if (a.near) w += 2LL * a.Q + WINDOW + 1;
  if (a.S > 1) w += 2LL * a.S * split_stride(a);
  return w;
}

template <int OP>
__device__ __forceinline__ float mul(float t, float w) {
  return OP == OP_ADD ? __fmul_rn(t, w) : __fadd_rn(t, w);
}

// The value an empty accumulator holds: no candidate beats it strictly
// except a better one; -0.0 is add's exact identity.
template <int OP>
__device__ __forceinline__ float empty_acc() {
  return OP == OP_MIN   ? __int_as_float(0x7f800000)
         : OP == OP_MAX ? __int_as_float(0xff800000)
                        : __int_as_float(0x80000000);
}

template <int OP>
__device__ __forceinline__ bool better(float v, float acc) {
  return OP == OP_MIN ? v < acc : v > acc;
}

template <int OP>
__device__ __forceinline__ void fold(float v, int j, float& acc, int& arg) {
  if (OP == OP_ADD) {
    acc = __fadd_rn(acc, v);
  } else if (better<OP>(v, acc)) {
    acc = v;
    arg = j;
  }
}

// fold() where `on`, by selects rather than a branch (lanes of a warp that
// disagree on `on` do not diverge).
template <int OP>
__device__ __forceinline__ void fold_if(bool on, float v, int j, float& acc,
                                        int& arg) {
  if (OP == OP_ADD) {
    const float sum = __fadd_rn(acc, v);
    acc = on ? sum : acc;
  } else {
    const bool take = on && better<OP>(v, acc);
    acc = take ? v : acc;
    arg = take ? j : arg;
  }
}

// Fold cnt consecutive candidates src[0..cnt) of lanes j.. into the
// accumulators: four apart for min/max, in order into acc[0] for add. L2:
// load past L1 (K1's table on a cluster, written by other SMs).
template <int OP, bool WEIGHTED, bool L2>
__device__ __forceinline__ void fold_span(const float* src, const float* wrow,
                                          int j, int cnt, float (&acc)[4],
                                          int (&arg)[4]) {
  int u = 0;
#pragma unroll 2
  for (; u + 4 <= cnt; u += 4) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = L2 ? __ldcg(src + u + e) : src[u + e];
    if (WEIGHTED) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = mul<OP>(v[e], wrow[j + u + e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = OP == OP_ADD ? 0 : e;
      fold<OP>(v[e], j + u + e, acc[x], arg[x]);
    }
  }
  for (; u < cnt; ++u) {
    float v = L2 ? __ldcg(src + u) : src[u];
    if (WEIGHTED) v = mul<OP>(v, wrow[j + u]);
    fold<OP>(v, j + u, acc[0], arg[0]);
  }
}

// The far lanes of the cell at chunk position p (table index i, ring slot
// `slot`) among lanes [jlo, jhi): every such lane with a_j > p, in
// ascending j.
template <int OP, bool WEIGHTED, bool RING>
__device__ __forceinline__ void far_fold(const Args& a, const float* tab,
                                         int i, int slot, int p, int jlo,
                                         int jhi, const float* wrow,
                                         float& acc_out, int& arg_out) {
  float acc[4];
  int arg[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[e] = empty_acc<OP>();
    arg[e] = NO_ARG;
  }
  for (int r = 0; r < a.nruns; ++r) {
    const int4 run = __ldg(a.runs + r);          // (a0, j0, len)
    if (run.x <= p || run.y >= jhi) break;       // later runs: nearer, later
    const int t0 = max(0, jlo - run.y);          // the run's lanes in range,
    const int cnt = min(min(run.z, run.x - p), jhi - run.y) - t0;  // far
    if (cnt <= 0) continue;
    const int a0 = run.x - t0, j0 = run.y + t0;
    if (RING) {
      int src = slot - a0;
      if (src < 0) src += a.R;
      const int seg = min(cnt, a.R - src);
      fold_span<OP, WEIGHTED, false>(tab + src, wrow, j0, seg, acc, arg);
      if (seg < cnt)
        fold_span<OP, WEIGHTED, false>(tab, wrow, j0 + seg, cnt - seg, acc, arg);
    } else if (a.C > 1) {
      fold_span<OP, WEIGHTED, true>(tab + (i - a0), wrow, j0, cnt, acc, arg);
    } else {
      fold_span<OP, WEIGHTED, false>(tab + (i - a0), wrow, j0, cnt, acc, arg);
    }
  }
  if (OP != OP_ADD) {
#pragma unroll
    for (int e = 1; e < 4; ++e)
      if (better<OP>(acc[e], acc[0]) || (acc[e] == acc[0] && arg[e] < arg[0])) {
        acc[0] = acc[e];
        arg[0] = arg[e];
      }
  }
  acc_out = acc[0];
  arg_out = arg[0];
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// End of a chunk: the CTA's barrier, or the cluster's with release/acquire
// semantics, so that every replica's ring writes are seen by every CTA.
__device__ __forceinline__ void chunk_barrier(int C) {
  if (C > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

// near == 1: offset 1 (lane k-1) is the only near lane. Warp 0 walks the
// chunk 32 cells at a time: each lane loads one cell's partial and weight,
// shuffles hand them to every lane, and all lanes run the same chain of
// add, compare and select (the shuffles do not depend on it); lane e keeps
// cell e's result and stores it.
template <int OP, bool WEIGHTED>
__device__ __forceinline__ void near_offset1(const Args& a,
                                             float* __restrict__ pacc,
                                             int* __restrict__ parg,
                                             const float* __restrict__ wt,
                                             int KS, const float* wglob,
                                             int cnt) {
  const int lane = threadIdx.x & 31;
  const int jl = a.k - 1;
  float prev = 0.0f;
  for (int p0 = 0; p0 < cnt; p0 += 32) {
    const int p = min(p0 + lane, cnt - 1);
    const float mp = pacc[p];
    const int mg = parg[p];
    float mw = 0.0f;
    if (WEIGHTED) mw = wt ? wt[p * KS + jl] : wglob[(long long)p * a.k + jl];
    float racc = mp;
    int rarg = mg;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float acc = __shfl_sync(0xffffffffu, mp, e);
      int arg = __shfl_sync(0xffffffffu, mg, e);
      if (p0 + e > 0) {
        const float w = WEIGHTED ? __shfl_sync(0xffffffffu, mw, e) : 0.0f;
        fold<OP>(WEIGHTED ? mul<OP>(prev, w) : prev, jl, acc, arg);
      }
      prev = acc;
      if (lane == e) {
        racc = acc;
        rarg = arg;
      }
    }
    if (p0 + lane < cnt) {
      pacc[p0 + lane] = racc;
      parg[p0 + lane] = rarg;
    }
  }
}

// near == 2: warp 0 holds cells A and B = A + 32 of the next 64; after
// cell q is finished, a lane holds A = q + dA, dA = 1 + ((lane - q - 1)
// mod 32). Step q broadcasts cell q from the lane holding it, which then
// takes cell q + 64; every lane folds the broadcast value into A and B
// through the lanes of offsets dA and dA + 32 (lane_of, -1 where no near
// lane has that offset). The walk goes 32 steps at a time, unrolled: in a
// block the owner of step e is lane e and each lane's offsets depend on e
// alone, so the lane numbers (shuffled from two registers), the weights,
// the block's next partials and its finished cells are all independent of
// the broadcast values and issue around the chain, whose links are one
// shuffle and one fold per cell.
template <int OP, bool WEIGHTED>
__device__ __forceinline__ void near_window(const Args& a,
                                            float* __restrict__ pacc,
                                            int* __restrict__ parg,
                                            const int* __restrict__ lane_of,
                                            const float* __restrict__ wt,
                                            int KS, const float* wglob,
                                            int cnt) {
  const int lane = threadIdx.x & 31;
  const int laneA = lane_of[lane + 1], laneB = lane_of[lane + 33];
  const bool two = __any_sync(0xffffffffu, laneB >= 0);  // offsets above 32
  const float* wbase = wt ? wt : wglob;  // staged rows, or device memory
  const int wstride = wt ? KS : a.k;
  auto weight = [&](int p, int j) {     // no branch: a clamped, valid address
    return WEIGHTED ? wbase[min(p, cnt - 1) * wstride + max(j, 0)] : 0.0f;
  };
  float aA = lane < cnt ? pacc[lane] : 0.0f;
  int gA = lane < cnt ? parg[lane] : NO_ARG;
  float aB = lane + 32 < cnt ? pacc[lane + 32] : 0.0f;
  int gB = lane + 32 < cnt ? parg[lane + 32] : NO_ARG;
  for (int q0 = 0; q0 < cnt; q0 += 32) {
    const int nb = q0 + WINDOW + lane;  // lane's next cell, taken at step lane
    const float nA = nb < cnt ? pacc[nb] : 0.0f;
    const int nG = nb < cnt ? parg[nb] : NO_ARG;
    float fA = 0.0f;                    // the cell this lane finishes
    int fG = NO_ARG;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int q = q0 + e;
      const int d = 1 + ((lane - e - 1) & 31);  // A - q after step q
      const int A = q + d;
      const int jA = __shfl_sync(0xffffffffu, laneA, d - 1);
      const int jB = two ? __shfl_sync(0xffffffffu, laneB, d - 1) : -1;
      const bool onA = jA >= 0 && A < cnt, onB = jB >= 0 && A + 32 < cnt;
      const float wA = weight(A, jA), wB = two ? weight(A + 32, jB) : 0.0f;
      const bool own = lane == e;
      const float v = __shfl_sync(0xffffffffu, aA, e);
      fA = own ? aA : fA;               // cell q is finished: keep it
      fG = own ? gA : fG;
      aA = own ? aB : aA;
      gA = own ? gB : gA;
      aB = own ? nA : aB;
      gB = own ? nG : gB;
      fold_if<OP>(onA, WEIGHTED ? mul<OP>(v, wA) : v, jA, aA, gA);
      fold_if<OP>(onB, WEIGHTED ? mul<OP>(v, wB) : v, jB, aB, gB);
    }
    if (q0 + lane < cnt) {              // hand back the block's cells
      pacc[q0 + lane] = fA;
      parg[q0 + lane] = fG;
    }
  }
}

template <int OP, bool WEIGHTED, bool ARGS, bool RING>
__global__ void __launch_bounds__(1024)
walk_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  const int C = a.C;
  const int rank = C > 1 ? static_cast<int>(cooperative_groups::this_cluster().block_rank()) : 0;
  const long long b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int Qc = chunk_per_cta(a);
  const int SS = split_stride(a);           // threads of one lane block
  const int LB = (a.k + a.S - 1) / a.S;     // lanes of one block
  const int KS = a.k | 1;
  float* st = a.out + b * a.n;
  int* ar = ARGS ? a.args + b * a.n : nullptr;
  const float* w = WEIGHTED ? a.weights + b * (long long)a.n * a.k : nullptr;

  float* ring = smem;
  float* wbuf = smem + (RING ? a.R : 0);
  float* pacc = wbuf + (a.stage ? 2 * Qc * KS : 0);
  int* parg = reinterpret_cast<int*>(pacc + a.Q);
  int* lane_of = parg + a.Q;
  float* sacc = a.near ? reinterpret_cast<float*>(lane_of + WINDOW + 1) : pacc;
  int* sarg = reinterpret_cast<int*>(sacc + a.S * split_stride(a));

  float* peers[MAX_CLUSTER];  // the ring's replicas, this CTA's among them
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q)
    peers[q] = RING && C > 1 && q < C
                   ? cooperative_groups::this_cluster().map_shared_rank(ring, q)
                   : ring;

  for (int i = tid; i < a.a1; i += blockDim.x) {
    const float v = a.init[b * a.a1 + i];
    if (RING) ring[i] = v;
    if (rank == 0) {
      st[i] = v;
      if (ARGS) ar[i] = -1;
    }
  }
  if (a.near == 2) {
    for (int d = tid; d <= WINDOW; d += blockDim.x) {
      int j = -1;
      for (int r = 0; r < a.nruns && d < a.Q; ++r) {
        const int4 run = a.runs[r];
        if (run.x >= d && run.x - run.z < d) j = run.y + (run.x - d);
      }
      lane_of[d] = j;
    }
  }

  auto stage_rows = [&](int s, int buf) {
    const int p0 = rank * Qc;
    const int rows = min(Qc, min(a.Q, a.n - s) - p0);
    if (rows <= 0) return;
    const float* src = w + (long long)(s + p0) * a.k;
    float* dst = wbuf + buf * Qc * KS;
    // element e = r * k + c, stepped by the block without a division
    int r = tid / a.k, c = tid - r * a.k;
    const int dr = blockDim.x / a.k, dc = blockDim.x - dr * a.k;
    for (int e = tid; e < rows * a.k; e += blockDim.x) {
      cp_async4(dst + r * KS + c, src + e);
      r += dr;
      c += dc;
      if (c >= a.k) {
        c -= a.k;
        ++r;
      }
    }
  };

  auto write_cell = [&](int i, int slot, float acc, int arg) {
    if (RING) {
      if (C > 1) {
#pragma unroll
        for (int q = 0; q < MAX_CLUSTER; ++q)
          if (q < C) peers[q][slot] = acc;
      } else {
        ring[slot] = acc;
      }
    }
    st[i] = acc;
    if (ARGS) ar[i] = arg == NO_ARG ? 0 : arg;
  };

  if (WEIGHTED && a.stage) {
    stage_rows(a.a1, 0);
    cp_async_commit();
    cp_async_wait_all();
  }
  chunk_barrier(C);

  int sbase = a.a1;  // ring slot of the chunk's first cell
  int buf = 0;
  for (int s = a.a1; s < a.n; s += a.Q) {
    const int cnt = min(a.Q, a.n - s);
    const float* wt = nullptr;
    if (WEIGHTED && a.stage) {
      if (s + a.Q < a.n) stage_rows(s + a.Q, buf ^ 1);
      cp_async_commit();
      wt = wbuf + buf * Qc * KS;
    }
    const float* wglob = WEIGHTED ? w + (long long)s * a.k : nullptr;
    const int c = tid % SS, split = tid / SS;  // this CTA's cell, lane block
    const int p = rank * Qc + c;
    const bool live = c < Qc && p < cnt;
    int slot = sbase + p;
    if (RING && slot >= a.R) slot -= a.R;
    float acc = 0.0f;
    int arg = NO_ARG;
    if (live) {
      const float* wrow = nullptr;
      if (WEIGHTED) wrow = wt ? wt + c * KS : wglob + (long long)p * a.k;
      far_fold<OP, WEIGHTED, RING>(a, RING ? ring : st, s + p, slot, p,
                                   split * LB, min(a.k, (split + 1) * LB), wrow,
                                   acc, arg);
      if (a.S > 1) {
        sacc[tid] = acc;
        sarg[tid] = arg;
      } else if (a.near == 0) {
        write_cell(s + p, slot, acc, arg);
      } else {
        pacc[p] = acc;
        parg[p] = arg;
      }
    }
    if (a.S > 1) {  // merge the lane blocks in order: (value, then lane)
      __syncthreads();
      if (live && split == 0) {
        for (int x = 1; x < a.S; ++x) {
          const float v = sacc[x * SS + c];
          const int j = sarg[x * SS + c];
          if (better<OP>(v, acc) || (v == acc && j < arg)) {
            acc = v;
            arg = j;
          }
        }
        if (a.near == 0) {
          write_cell(s + p, slot, acc, arg);
        } else {
          pacc[p] = acc;
          parg[p] = arg;
        }
      }
    }
    if (a.near) {
      __syncthreads();
      if (a.near == 1) {
        if (tid < 32) near_offset1<OP, WEIGHTED>(a, pacc, parg, wt, KS, wglob, cnt);
      } else if (tid < 32) {
        near_window<OP, WEIGHTED>(a, pacc, parg, lane_of, wt, KS, wglob, cnt);
      }
      __syncthreads();
      if (live && split == 0) write_cell(s + p, slot, pacc[p], parg[p]);
    }
    if (WEIGHTED && a.stage) cp_async_wait_all();
    chunk_barrier(C);
    if (RING) {
      sbase += a.Q;
      if (sbase >= a.R) sbase -= a.R;
    }
    buf ^= 1;
  }
}

// ---- host side: kernel choice and launch ----

template <int OP, bool WEIGHTED, bool ARGS, bool RING>
inline cudaError_t configure(const void** kernel, size_t smem) {
  auto k = walk_kernel<OP, WEIGHTED, ARGS, RING>;
  *kernel = reinterpret_cast<const void*>(k);
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool RING>
inline cudaError_t pick(int op, bool weighted, bool args, size_t smem,
                        const void** kernel) {
  if (op == OP_ADD) {
    if (args) return cudaErrorInvalidValue;
    return weighted ? configure<OP_ADD, true, false, RING>(kernel, smem)
                    : configure<OP_ADD, false, false, RING>(kernel, smem);
  }
  if (op == OP_MIN) {
    if (weighted)
      return args ? configure<OP_MIN, true, true, RING>(kernel, smem)
                  : configure<OP_MIN, true, false, RING>(kernel, smem);
    return args ? configure<OP_MIN, false, true, RING>(kernel, smem)
                : configure<OP_MIN, false, false, RING>(kernel, smem);
  }
  if (op == OP_MAX) {
    if (weighted)
      return args ? configure<OP_MAX, true, true, RING>(kernel, smem)
                  : configure<OP_MAX, true, false, RING>(kernel, smem);
    return args ? configure<OP_MAX, false, true, RING>(kernel, smem)
                : configure<OP_MAX, false, false, RING>(kernel, smem);
  }
  return cudaErrorInvalidValue;
}

inline cudaLaunchConfig_t config(int grid, int threads, size_t smem, int C,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  return cfg;
}

// How many clusters of C CTAs (`threads` threads and `smem` bytes each) of
// the kernel that op / weighted / args pick the card can run at once
// (cudaOccupancyMaxActiveClusters); 0 if none, or if it refuses the query.
template <bool RING>
inline int max_clusters(int op, bool weighted, bool args, int C, int threads,
                        long long smem) {
  const void* kernel = nullptr;
  if (pick<RING>(op, weighted, args, static_cast<size_t>(smem), &kernel) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      config(C, threads, static_cast<size_t>(smem), C, 0, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a refused query leaves no error behind
    return 0;
  }
  return clusters;
}

// Launch the walk over `batch` instances, C CTAs each; returns a cudaError_t.
template <bool RING>
inline int launch(const Args& a, int batch, int threads, int op,
                  long long smem, cudaStream_t stream) {
  if (a.C < 1 || a.C > MAX_CLUSTER || (a.C > 1 && a.near != 0) || a.S < 1 ||
      (a.S > 1 && op == OP_ADD) ||
      threads < a.S * split_stride(a) ||
      smem_words(a, RING) * 4 > smem)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = nullptr;
  cudaError_t rc = pick<RING>(op, a.weights != nullptr, a.args != nullptr,
                              static_cast<size_t>(smem), &kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(batch * a.C, threads, static_cast<size_t>(smem),
                                  a.C, stream, &attr);
  Args copy = a;
  void* params[] = {&copy};
  rc = cudaLaunchKernelExC(&cfg, kernel, params);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sdp_walk
