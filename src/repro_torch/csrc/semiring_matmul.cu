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
// contracts it there); without weights the candidate is A + B. The min
// keeps a NaN once it has seen one (torch.amin's rule; PTX min.NaN), and
// no candidate's rounding depends on which k comes first, so any partition
// of K gives the plain version's result bit for bit.
//
// What bounds it on this card: (min,+) has no tensor-core form, so each
// candidate is an add, a min and, weighted, an FMA on the CUDA cores
// (float32 at 67 TFLOP/s). Two shapes matter, and kernels/semiring_matmul.py
// ::plan picks the regime for each launch (the launcher checks the plan):
//
//   * "split" (M, N <= 16: every launch of the blocked MCM route, a batch
//     of 16 x 16 outputs with K up to 992). The work is small and the
//     latency of walking K is the cost, so K is split: over a
//     thread-block cluster of C CTAs (rank r takes K columns [r*slice,
//     (r+1)*slice)), and inside a CTA over G groups of 256 threads, one
//     output a thread. Groups merge in shared memory; ranks 1..C-1 write
//     their partial minima into rank 0's shared memory (DSMEM), and after
//     one cluster barrier rank 0 folds them and writes C. One launch, no
//     workspace; a launch fills the card with a few K stages per CTA.
//   * "register" (larger M or N: the weighted 1024^3 square). 64 x 64
//     output tiles, 256 threads of 4 x 4 outputs each; a thread reads its
//     4 columns of B as one float4 and its 4 rows of A as broadcasts;
//     w = av_i*gv_k once per (i, k) per thread, leaving an add, an FMA
//     and a min per candidate. Few tiles and a long K split over a
//     cluster as above.
//
// Both stage K in steps of KS columns per group through a ring of S stages
// filled by cp.async, 16 bytes a copy where rows start on 16 bytes (the
// blocked route's strided views of the table, passed as they are, and
// contiguous operands of width divisible by 4), 4 bytes elsewhere; all
// stages in flight at once where the CTA's slice fits the ring: the
// path's launches pay one memory latency, not one per stage. A group's last,
// ragged step walks only its valid columns, so padding never enters a
// candidate. Operands have one or two batch axes (outer, inner), each
// with its own element stride, unit stride along their last axis; C is
// contiguous.
//
// Built with --fmad=false; the only FMA is the explicit __fmaf_rn.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LG_KS = 5;
constexpr int KS = 1 << LG_KS;  // K columns a group takes per stage
constexpr int GROUP = 256;      // threads of one K group
constexpr int MAX_GROUPS = 4;
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_STAGES = 8;     // ring depth
constexpr int SMEM_OPTIN = 232448;

struct Operand {        // element strides: outer batch, inner batch, row
  const float* p;
  long long s1, s0, row;
};

struct Params {
  Operand a, b, av, gv, bv;
  float* c;
  int nb0;              // inner batch extent (batch = outer x nb0)
  int M, N, K;
  int tiles_n, tiles;   // output tiles along N, and per batch entry
  int C, lg_groups, slice, stages;
};

// Output tile side of a thread holding R x R outputs.
template <int R>
struct Geom {
  static constexpr int TILE = R == 1 ? 16 : 64;
};

// Floats of one stage of W columns: A as [TILE][W + 4] (rows 16-byte
// aligned), B as [W][TILE], gv as [W].
__host__ __device__ inline long long stage_floats(int tile, int W) {
  return (long long)tile * (W + 4) + (long long)W * tile + W;
}

// Floats of one CTA's shared memory: a ring of S stages of KS * G
// columns, the group merge aliased onto it, and C - 1 receive slots of a
// tile (kernels/semiring_matmul.py::smem_bytes mirrors it).
template <int R>
__host__ __device__ long long smem_floats(int C, int G, int S) {
  using T = Geom<R>;
  const long long stage = S * stage_floats(T::TILE, G * KS);
  const long long merge = (long long)(G - 1) * T::TILE * T::TILE;
  return (stage > merge ? stage : merge) + (long long)(C - 1) * T::TILE * T::TILE;
}

// ---- device primitives
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes to `dst` of which the first `bytes` come from `src` (both
// 16-byte aligned), the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n (< MAX_STAGES) committed cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// min that keeps a NaN (either input NaN gives NaN), one instruction
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// `p` in the shared memory of the cluster's CTA of rank 0
__device__ __forceinline__ float* rank0(float* p) {
  return cooperative_groups::this_cluster().map_shared_rank(p, 0);
}
// ---- end of device primitives ----

// A thread's R values of A at one k: rows `pitch` floats apart.
template <int R>
__device__ __forceinline__ void load_col(float (&v)[R], const float* p, int pitch) {
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = p[r * pitch];
}

template <int R>
__device__ __forceinline__ void load_row(float (&v)[R], const float* p) {
  if constexpr (R == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = p[r];
  }
}

// One k of a thread's R x R outputs: as (its R rows of the A stage, `pa`
// floats apart), bs (its R columns of the B stage), g (gv at k).
template <int R, bool W>
__device__ __forceinline__ void candidate_step(float (&acc)[R][R], const float* as, int pa,
                                               const float* bs, float g,
                                               const float (&avi)[R],
                                               const float (&bvj)[R]) {
  float a[R], b[R], w[R];
  load_col<R>(a, as, pa);
  load_row<R>(b, bs);
  if (W) {
#pragma unroll
    for (int r = 0; r < R; ++r) w[r] = __fmul_rn(avi[r], g);
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      float v = __fadd_rn(a[r], b[c]);
      if (W) v = __fmaf_rn(w[r], bvj[c], v);
      acc[r][c] = min_nan(acc[r][c], v);
    }
}

template <int R, bool W>
__global__ void __launch_bounds__(R == 1 ? GROUP * MAX_GROUPS : GROUP)
tropical_matmul_kernel(const __grid_constant__ Params p) {
  using T = Geom<R>;
  constexpr int TILE = T::TILE, TW = TILE / R;
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, lg = p.lg_groups, G = 1 << lg;
  const int W_COLS = KS << lg;                   // K columns of one stage
  const int threads = GROUP << lg;
  const int tid = threadIdx.x, grp = tid >> 8, lt = tid & (GROUP - 1);
  const int ty = lt / TW, tx = lt % TW;
  if (C > 1) cluster_arrive_relaxed();           // every CTA runs before DSMEM writes

  const int rank = static_cast<int>(blockIdx.x % C);
  const long long unit = blockIdx.x / C;
  const long long bidx = unit / p.tiles;
  const int tile = static_cast<int>(unit % p.tiles);
  const int i0 = (tile / p.tiles_n) * TILE, j0 = (tile % p.tiles_n) * TILE;
  const long long b1 = bidx / p.nb0, b0 = bidx % p.nb0;
  const float* A = p.a.p + b1 * p.a.s1 + b0 * p.a.s0;
  const float* B = p.b.p + b1 * p.b.s1 + b0 * p.b.s0;
  const int M = p.M, N = p.N;
  const int k_lo = static_cast<int>(min((long long)p.K, (long long)rank * p.slice));
  const int k_hi = static_cast<int>(min((long long)p.K, (long long)k_lo + p.slice));
  const int nst = (k_hi - k_lo + W_COLS - 1) / W_COLS;

  float avi[R], bvj[R];
  const float* GV = nullptr;
  if (W) {
    const float* AV = p.av.p + b1 * p.av.s1 + b0 * p.av.s0;
    const float* BV = p.bv.p + b1 * p.bv.s1 + b0 * p.bv.s0;
    GV = p.gv.p + b1 * p.gv.s1 + b0 * p.gv.s0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + ty * R + r, j = j0 + tx * R + r;
      avi[r] = i < M ? AV[i] : 0.0f;
      bvj[r] = j < N ? BV[j] : 0.0f;
    }
  }

  // stage buffers: [buf][i][PA] A, [buf][kk][TILE] B, [buf][kk] gv
  const int PA = W_COLS + 4;
  const int a_sz = TILE * PA, b_sz = W_COLS * TILE;
  const int S = p.stages;
  float* As = smem;
  float* Bs = As + S * a_sz;
  float* Gs = Bs + S * b_sz;
  float* recv = smem + smem_floats<R>(1, G, S);  // C - 1 slots of TILE x TILE

  // 16-byte copies where the rows start on 16 bytes (the route's views and
  // contiguous operands with a width divisible by 4), 4-byte ones elsewhere
  const bool a_vec = p.a.row % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                     k_lo % 4 == 0;
  const bool b_vec = p.b.row % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  auto copy4 = [](float* dst, const float* src, int n, bool vec) {
    if (vec) {
      cp_async16(dst, src, 4 * n);
    } else {
      for (int q = 0; q < n; ++q) cp_async4(dst + q, src + q);
    }
  };
  auto issue = [&](int s, int buf) {
    const int k0 = k_lo + s * W_COLS;
    float* as = As + buf * a_sz;
    float* bs = Bs + buf * b_sz;
    for (int e = tid; e < TILE * (W_COLS / 4); e += threads) {   // A in 4-column runs
      const int i = e >> (LG_KS - 2 + lg), k = k0 + 4 * (e & (W_COLS / 4 - 1));
      if (i0 + i < M && k < k_hi)
        copy4(as + i * PA + (k - k0), A + (long long)(i0 + i) * p.a.row + k,
              min(4, k_hi - k), a_vec);
    }
    for (int e = tid; e < W_COLS * (TILE / 4); e += threads) {   // B in 4-column runs
      const int kk = e / (TILE / 4), j = 4 * (e % (TILE / 4));
      if (k0 + kk < k_hi && j0 + j < N)
        copy4(bs + kk * TILE + j, B + (long long)(k0 + kk) * p.b.row + j0 + j,
              min(4, N - j0 - j), b_vec);
    }
    if (W)
      for (int e = tid; e < W_COLS; e += threads)
        if (k0 + e < k_hi) cp_async4(Gs + buf * W_COLS + e, GV + k0 + e);
    cp_async_commit();
  };

  float acc[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[r][c] = INFINITY;

  // the ring: up to S stages in flight (the whole slice where it fits), one
  // memory latency before the first stage instead of one per stage
  int issued = 0;
  for (; issued < min(S, nst); ++issued) issue(issued, issued);
  for (int s = 0; s < nst; ++s) {
    cp_async_wait_upto(issued - s - 1);          // stage s has landed
    __syncthreads();
    const int buf = s % S, kg = grp * KS;
    const int kn = min(KS, k_hi - (k_lo + s * W_COLS + kg));   // this group's columns
    const float* as = As + buf * a_sz + ty * R * PA + kg;
    const float* bs = Bs + buf * b_sz + kg * TILE + tx * R;
    const float* gs = Gs + buf * W_COLS + kg;
    if (kn == KS) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        candidate_step<R, W>(acc, as + kk, PA, bs + kk * TILE, W ? gs[kk] : 0.0f,
                             avi, bvj);
    } else {
      for (int kk = 0; kk < kn; ++kk)
        candidate_step<R, W>(acc, as + kk, PA, bs + kk * TILE, W ? gs[kk] : 0.0f,
                             avi, bvj);
    }
    __syncthreads();                             // buffer s % S is free again
    if (issued < nst) {
      issue(issued, issued % S);
      ++issued;
    }
  }

  // groups 1..G-1 into group 0 (the stage buffers are free now)
  constexpr int PER = R * R;
  if (G > 1) {
    if (grp > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c)
          smem[((grp - 1) * GROUP + lt) * PER + r * R + c] = acc[r][c];
    }
    __syncthreads();
    if (grp == 0)
      for (int g = 1; g < G; ++g)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < R; ++c)
            acc[r][c] = min_nan(acc[r][c], smem[((g - 1) * GROUP + lt) * PER + r * R + c]);
  }

  // ranks 1..C-1 into rank 0's receive slots, one cluster barrier
  if (C > 1) {
    cluster_wait();                              // rank 0 has started
    if (rank > 0 && grp == 0) {
      float* dst = rank0(recv + ((rank - 1) * GROUP + lt) * PER);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) dst[r * R + c] = acc[r][c];
    }
    cluster_arrive_release();
    cluster_wait();
    if (rank > 0) return;
    if (grp == 0)
      for (int q = 1; q < C; ++q)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < R; ++c)
            acc[r][c] = min_nan(acc[r][c], recv[((q - 1) * GROUP + lt) * PER + r * R + c]);
  }
  if (grp > 0) return;
  float* out = p.c + bidx * M * N;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + ty * R + r;
    if (i >= M) continue;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int j = j0 + tx * R + c;
      if (j < N) out[(long long)i * N + j] = acc[r][c];
    }
  }
}

using Kernel = void (*)(Params);

Kernel pick(int per_thread, bool weighted) {
  if (per_thread == 1)
    return weighted ? tropical_matmul_kernel<1, true> : tropical_matmul_kernel<1, false>;
  return weighted ? tropical_matmul_kernel<4, true> : tropical_matmul_kernel<4, false>;
}

long long smem_bytes(int per_thread, int C, int G, int S) {
  return 4 * (per_thread == 1 ? smem_floats<1>(C, G, S) : smem_floats<4>(C, G, S));
}

// Raise the kernel's dynamic shared memory cap to the card's opt-in and
// allow clusters of 16, once per variant and device.
cudaError_t configure(Kernel kernel, int variant) {
  static unsigned long long done[4] = {0, 0, 0, 0};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (done[variant] & bit) return cudaSuccess;
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPTIN);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc == cudaSuccess) done[variant] |= bit;
  return rc;
}

cudaLaunchConfig_t config(unsigned grid, int threads, long long smem, int C,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid_plan(int per_thread, int C, int G, int S) {
  return (per_thread == 1 || per_thread == 4) && C >= 1 && C <= MAX_CLUSTER &&
         (G == 1 || G == 2 || G == 4) && (per_thread == 1 || G == 1) && S >= 1 &&
         S <= MAX_STAGES && smem_bytes(per_thread, C, G, S) <= SMEM_OPTIN;
}

int log2_groups(int G) { return G == 4 ? 2 : G == 2 ? 1 : 0; }

}  // namespace

// Dynamic shared memory of one CTA of a plan (outputs per thread along a
// side 1 or 4, cluster C, groups G, ring stages S); -1 if the plan is not
// one the kernel takes.
extern "C" long long tropical_matmul_smem_bytes(int per_thread, int C, int G, int S) {
  if (!valid_plan(per_thread, C, G, S)) return -1;
  return smem_bytes(per_thread, C, G, S);
}

// How many clusters of C CTAs of a plan the card runs at once
// (cudaOccupancyMaxActiveClusters); 0 if none or refused.
extern "C" int tropical_matmul_max_clusters(int per_thread, int C, int G, int S) {
  if (!valid_plan(per_thread, C, G, S)) return 0;
  Kernel kernel = pick(per_thread, true);
  if (configure(kernel, (per_thread == 1 ? 0 : 2) + 1) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      config(C, GROUP * G, smem_bytes(per_thread, C, G, S), C, 0, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel),
                                     &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return clusters;
}

// a, b, c and the weights (av, gv, bv all given or all null) as float32
// pointers; strides (element counts): {a: outer, inner, row; b: outer,
// inner, row; av: outer, inner; gv: outer, inner; bv: outer, inner}, unit
// stride along every last axis; c (nb1, nb0, M, N) contiguous. The plan:
// per_thread 1 (split regime, 16 x 16 tiles) or 4 (register regime, 64 x
// 64 tiles), C CTAs a cluster over K, G groups a CTA, slice K columns a
// CTA (C * slice >= K), S stages in the ring. Returns a cudaError_t.
extern "C" int tropical_matmul_launch(const void* a, const void* b, const void* av,
                                      const void* gv, const void* bv, void* c,
                                      const long long* strides, int nb1, int nb0, int M,
                                      int N, int K, int per_thread, int C, int G,
                                      int slice, int S, void* stream) {
  if (nb1 <= 0 || nb0 <= 0 || M <= 0 || N <= 0) return 0;
  if (!valid_plan(per_thread, C, G, S) || K < 0 || slice < 1 || (long long)C * slice < K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = per_thread == 1 ? Geom<1>::TILE : Geom<4>::TILE;
  const long long tiles_n = (N + tile - 1) / tile;
  const long long tiles = tiles_n * ((M + tile - 1) / tile);
  const long long grid = (long long)nb1 * nb0 * tiles * C;
  if (grid >= 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const bool weighted = av != nullptr;
  Kernel kernel = pick(per_thread, weighted);
  cudaError_t rc = configure(kernel, (per_thread == 1 ? 0 : 2) + (weighted ? 1 : 0));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  Params p;
  p.a = {static_cast<const float*>(a), strides[0], strides[1], strides[2]};
  p.b = {static_cast<const float*>(b), strides[3], strides[4], strides[5]};
  p.av = {static_cast<const float*>(av), strides[6], strides[7], 0};
  p.gv = {static_cast<const float*>(gv), strides[8], strides[9], 0};
  p.bv = {static_cast<const float*>(bv), strides[10], strides[11], 0};
  p.c = static_cast<float*>(c);
  p.nb0 = nb0;
  p.M = M;
  p.N = N;
  p.K = K;
  p.tiles_n = static_cast<int>(tiles_n);
  p.tiles = static_cast<int>(tiles);
  p.C = C;
  p.lg_groups = log2_groups(G);
  p.slice = slice;
  p.stages = S;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(static_cast<unsigned>(grid), GROUP * G,
                                  smem_bytes(per_thread, C, G, S), C,
                                  static_cast<cudaStream_t>(stream), &attr);
  void* params[] = {&p};
  rc = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), params);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
