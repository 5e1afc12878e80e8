// Wavefront pipeline for the grid family (alignment grids and parse
// charts), hand-written for Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/grid_pipeline.py::grid_pipeline_pallas and
//   ::grid_pipeline_pallas_with_args (bodies: _make_antidiag_kernel,
//   _make_spandiag_kernel).
//
// antidiag (needleman_wunsch, gotoh, edit_distance_grid, lcs_grid):
//   ST[p, i, j] = op_{l: p_to(l)=p} (ST[p_from(l), i-di, j-dj] + w_l[i, j])
// on the caller's row-major (R, C) planes. Every move steps forward
// (di, dj >= 0, di + dj >= 1), so each cell's sources lie up and to the
// left. The grid is cut into T x T tiles (the wrapper's plan: the largest
// that fits shared memory), run as a wavefront of tiles: tile (I, J) starts
// once (I-1, J) and (I, J-1) are done, and with them every tile up and to
// the left. Tiles are taken from a ticket counter in that order (tile
// fronts I + J ascending, then instance, then I), one at a time by each of
// the persistent CTAs, so the least undone ticket can always run: the
// launch is cooperative (every CTA resident), and no CTA waits on a tile
// that no running CTA will finish. A tile:
//   * stages its weights, init (into its own cells) and init_mask planes
//     into shared memory with coalesced row copies (cp.async), before it
//     waits for its neighbours, so their latency overlaps the wait;
//   * waits for the ready flags of (I-1, J) and (I, J-1) (acquire), then
//     loads a halo of up to HI rows above and HJ columns left of it from
//     the finished table, past L1 (ld.global.cg);
//   * sweeps its inner anti-diagonals with a __syncthreads between them,
//     one thread per (plane, row), the same pair in every tile, holding
//     the first four moves into its plane in registers. Where those are
//     all of them and all reach only the tile or its halo (every zoo
//     problem), a step issues all its shared-memory loads at once with no
//     bounds tests (halo cells outside the grid hold the semiring zero),
//     then folds in declaration order; otherwise each move is tested,
//     sources farther than the halo come from the finished table in
//     device memory, and moves past the fourth from shared memory;
//   * writes its cells back as rows and releases its flag.
// A move whose source is outside the grid contributes nothing and reads
// nothing; a preset cell takes init and arg -1; a plane no move targets
// keeps init where preset and the semiring zero elsewhere, with args -1;
// cell (0, 0), which no move reaches, keeps that initial value too.
// Shared-memory rows have even strides, so a warp's reads along an
// anti-diagonal fall on distinct banks.
//
// spandiag (cky): the triangular split recurrence with a plane axis,
//   ST[A, lin(i,d)] = op_{e, r: A(r)=A} ((ST[B(r), lin(i,e)]
//                                        + ST[C(r), lin(i+e+1, d-e-1)]) + rw[r])
// one span diagonal d per step, d = 1 .. n-1; threads cover the (plane,
// lane) pairs of the diagonal, lanes fastest, so loads of one rule's
// operands are contiguous across a warp. Splits e ascend in the outer loop
// and the rules into A, in declaration order, in the inner one; the packed
// arg is e*NR + r. Diagonal 0 is preset from init (args -1); a plane no
// rule targets stays at the semiring zero with args -1.
//
// Both fold with strict improvement from the semiring zero, the arg
// starting at the first move or rule into the plane: ties keep the first
// candidate in declaration order, the first-occurrence rule of argmin /
// argmax. Sums associate as (left + right) + w with __fadd_rn, built with
// --fmad=false and no fast math. Max and min never mix +inf and -inf: the
// grid problems mask invalid moves with their own semiring zero.
//
// Mapping: antidiag, a persistent cooperative grid over the tiles of the
// whole batch; spandiag, one CTA per instance (grid = batch),
// __syncthreads() between diagonals. The per-plane move or rule lists (and
// the rule weights) live in shared memory. Tables stay in device memory
// (gotoh at 4096 x 4096 is 1.3 GB). Offsets into the tables are 64-bit:
// batch * L * R * C weights pass 2^31 in a batch of gotoh at 4096^2.
//
// What bounds it on this card: the byte bound is the inputs once plus the
// outputs once (0.38 ms at gotoh 4096^2). antidiag's serial chain is the
// tile wavefront, about 2 (R + C) shared-memory steps of one CTA each;
// spandiag runs its n - 1 diagonals on one SM per instance.
#include <cuda_runtime.h>
#include <math.h>

namespace {

// Offset of front t's first cell in the frontier-major layout: fronts grow
// by one lane up to m = min(R, C), hold width m up to M = max(R, C), then
// shrink.
__device__ __forceinline__ long long front_base(long long t, long long R,
                                                long long C) {
  const long long m = R < C ? R : C, M = R < C ? C : R;
  if (t <= m) return t * (t + 1) / 2;
  const long long head = m * (m + 1) / 2;
  if (t <= M) return head + (t - m) * m;
  const long long u = t - M;
  return head + (M - m) * m + u * m - u * (u + 1) / 2;
}

__device__ __forceinline__ long long diag_off(long long d, long long n) {
  return d * n - (d * (d - 1)) / 2;
}

template <bool MIN>
__device__ __forceinline__ bool improves(float v, float acc) {
  return MIN ? v < acc : v > acc;
}

// ---- device primitives
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src)
               : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
// ---- end of device primitives ----

constexpr int MR = 4;   // moves into a plane held in registers

struct TilePlan {
  int T;       // tile side
  int HI, HJ;  // halo rows above, columns left
  int S1;      // row stride of the table tile (with halo)
  int SW;      // row stride of the weight, mask and arg tiles
  int tab;     // ints of the move table, padded to 4
};

// mtab: starts[P+1], then per move (grouped by target plane, declaration
// order) its index l, source plane, di, dj: four arrays of L ints.
// sync: [0] the ticket counter, then one ready flag per tile (b, I, J); all
// zero at launch.
template <bool MIN, bool ARGS>
__global__ void grid_antidiag_kernel(const float* __restrict__ w_all,
                                     const float* __restrict__ init_all,
                                     const float* __restrict__ pm_all,
                                     const int* __restrict__ mtab,
                                     float* st_all, int* ar_all, int* sync,
                                     int B, int P, int R, int C, int L,
                                     TilePlan tp) {
  extern __shared__ int smem[];
  __shared__ long long ticket;
  const int T = tp.T, HI = tp.HI, HJ = tp.HJ, S1 = tp.S1, SW = tp.SW;
  const int tab = P + 1 + 4 * L;
  for (int k = threadIdx.x; k < tab; k += blockDim.x) smem[k] = mtab[k];
  const int* start = smem;
  const int* ml = smem + P + 1;
  const int* mf = ml + L;
  const int* mdi = mf + L;
  const int* mdj = mdi + L;
  const int TH = T + HI;
  float* sst = reinterpret_cast<float*>(smem + tp.tab);  // P x (T+HI) x S1
  float* sw = sst + (long long)P * TH * S1;                // L x T x SW
  float* spm = sw + (long long)L * T * SW;                 // P x T x SW
  int* sar = reinterpret_cast<int*>(spm + (long long)P * T * SW);  // P x T x SW
  __syncthreads();

  // this thread's (plane, row) in every tile (P * T <= blockDim), and the
  // first MR moves into its plane in registers: source offset in sst
  // relative to the cell, weight plane offset, index, source plane, di, dj
  const int p = threadIdx.x / T, r = threadIdx.x - p * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int k0 = p < P ? start[p] : 0, k1 = p < P ? start[p + 1] : 0;
  int rsrc[MR], rw[MR], rl[MR], rf[MR], rdi[MR], rdj[MR];
#pragma unroll
  for (int u = 0; u < MR; ++u) {
    const int m = u < k1 - k0 ? k0 + u : -1;
    rdi[u] = m < 0 ? 0 : mdi[m];
    rdj[u] = m < 0 ? 0 : mdj[m];
    rf[u] = m < 0 ? 0 : mf[m];
    rl[u] = m < 0 ? 0 : ml[m];
    rsrc[u] = (rf[u] * TH - rdi[u]) * S1 - rdj[u];
    rw[u] = rl[u] * T * SW;
  }
  // lean: all of the plane's moves in registers and within the halo
  const int nm = k1 - k0;
  bool lean = p < P && nm <= MR;
#pragma unroll
  for (int u = 0; u < MR; ++u)
    if (u < nm) lean = lean && rdi[u] <= HI && rdj[u] <= HJ;

  const long long N = (long long)R * C;
  const int nI = (R + T - 1) / T, nJ = (C + T - 1) / T;
  const long long total = (long long)B * nI * nJ;
  int* flags = sync + 1;
  const float zero = MIN ? INFINITY : -INFINITY;
  int front = 0;                       // tile front of the last ticket

  for (;;) {
    if (threadIdx.x == 0) ticket = atomicAdd(sync, 1);
    __syncthreads();
    const long long k = ticket;
    if (k >= total) break;
    while (k >= B * front_base(front + 1, nI, nJ)) ++front;
    const long long fb = front_base(front, nI, nJ);
    const long long len = front_base(front + 1, nI, nJ) - fb;
    const long long o = k - B * fb;
    const long long b = o / len;
    const int I = (front - nJ + 1 > 0 ? front - nJ + 1 : 0) + (int)(o - b * len);
    const int J = front - I;
    const int I0 = I * T, J0 = J * T;
    const int tr = min(T, R - I0), tc = min(T, C - J0);
    const float* w = w_all + b * L * N;
    const float* init = init_all + b * P * N;
    const float* pm = pm_all + b * P * N;
    float* st = st_all + b * P * N;
    int* ar = ARGS ? ar_all + b * P * N : nullptr;

    // inputs: rows of the weight, init and mask planes, a warp a row
    for (int row = warp; row < (L + 2 * P) * tr; row += warps) {
      const int pl = row / tr, r = row - pl * tr;
      const long long g = (long long)(I0 + r) * C + J0;
      const float* src;
      float* dst;
      if (pl < L) {
        src = w + pl * N + g;
        dst = sw + (pl * T + r) * SW;
      } else if (pl < L + P) {
        src = init + (pl - L) * N + g;
        dst = sst + ((pl - L) * TH + HI + r) * S1 + HJ;
      } else {
        src = pm + (pl - L - P) * N + g;
        dst = spm + ((pl - L - P) * T + r) * SW;
      }
      for (int c = lane; c < tc; c += 32) copy_async(dst + c, src + c);
    }
    wait_copies();
    if (threadIdx.x == 0) {
      const long long tile = b * nI * nJ + (long long)I * nJ + J;
      if (I > 0)
        while (ld_acquire(flags + tile - nJ) == 0) {
        }
      if (J > 0)
        while (ld_acquire(flags + tile - 1) == 0) {
        }
    }
    __syncthreads();
    // halo: HI rows above (HJ columns left of the tile and its tc), then
    // HJ columns left of its rows; cells outside the grid hold the semiring
    // zero, whose candidates never improve (zero + w is zero or NaN)
    const int hw = HJ + tc;
    for (int q = threadIdx.x; q < P * (HI * hw + tr * HJ); q += blockDim.x) {
      const int hp = q / (HI * hw + tr * HJ);
      const int h = q - hp * (HI * hw + tr * HJ);
      const int hr = h < HI * hw ? h / hw - HI : (h - HI * hw) / HJ;
      const int hc = h < HI * hw ? h % hw - HJ : (h - HI * hw) % HJ - HJ;
      const int i = I0 + hr, j = J0 + hc;
      sst[(hp * TH + HI + hr) * S1 + HJ + hc] =
          i >= 0 && j >= 0 ? __ldcg(st + hp * N + (long long)i * C + j) : zero;
    }
    __syncthreads();

    for (int s = 0; s < tr + tc - 1; ++s) {
      const int c = s - r;
      if (lean && r < tr && c >= 0 && c < tc) {
        // every source in the tile or its halo: no bounds tests, all loads
        // at once, then the fold in declaration order
        const int at = (HI + r) * S1 + HJ + c;
        float* cell = sst + p * TH * S1 + at;
        const float pre = spm[(p * T + r) * SW + c], init_v = *cell;
        float src[MR], wv[MR];
#pragma unroll
        for (int u = 0; u < MR; ++u) {
          if (u < nm) {
            src[u] = sst[rsrc[u] + at];
            wv[u] = sw[rw[u] + r * SW + c];
          }
        }
        float acc = zero;
        int arg = rl[0];
#pragma unroll
        for (int u = 0; u < MR; ++u) {
          if (u < nm) {
            const float v = __fadd_rn(src[u], wv[u]);
            if (improves<MIN>(v, acc)) {
              acc = v;
              arg = rl[u];
            }
          }
        }
        if (pre > 0.0f) {
          acc = init_v;
          arg = -1;
        } else if (I0 + r + J0 + c == 0 || nm == 0) {
          acc = zero;
          arg = -1;
        }
        *cell = acc;
        if (ARGS) sar[(p * T + r) * SW + c] = arg;
      } else if (p < P && r < tr && c >= 0 && c < tc) {
        const int i = I0 + r, j = J0 + c;
        const int at = (HI + r) * S1 + HJ + c;   // the cell in a plane of sst
        float* cell = sst + p * TH * S1 + at;
        const bool preset = spm[(p * T + r) * SW + c] > 0.0f;
        float acc = preset ? *cell : zero;
        int arg = -1;
        if (!preset && i + j > 0 && k0 < k1) {
          arg = rl[0];
          bool ok[MR];
          float src[MR], wv[MR];
#pragma unroll
          for (int u = 0; u < MR; ++u) {   // loads first, then the fold
            ok[u] = u < k1 - k0 && i >= rdi[u] && j >= rdj[u];
            if (ok[u]) {
              src[u] = r - rdi[u] >= -HI && c - rdj[u] >= -HJ
                           ? sst[rsrc[u] + at]
                           : __ldcg(st + rf[u] * N + (long long)(i - rdi[u]) * C + (j - rdj[u]));
              wv[u] = sw[rw[u] + r * SW + c];
            }
          }
#pragma unroll
          for (int u = 0; u < MR; ++u) {
            if (ok[u]) {
              const float v = __fadd_rn(src[u], wv[u]);
              if (improves<MIN>(v, acc)) {
                acc = v;
                arg = rl[u];
              }
            }
          }
          for (int m = k0 + MR; m < k1; ++m) {   // moves past the first MR
            const int di = mdi[m], dj = mdj[m];
            if (i < di || j < dj) continue;        // source outside the grid
            const int sr = r - di, sc = c - dj;
            const float v = __fadd_rn(
                sr >= -HI && sc >= -HJ
                    ? sst[(mf[m] * TH + HI + sr) * S1 + HJ + sc]
                    : __ldcg(st + mf[m] * N + (long long)(i - di) * C + (j - dj)),
                sw[(ml[m] * T + r) * SW + c]);
            if (improves<MIN>(v, acc)) {
              acc = v;
              arg = ml[m];
            }
          }
        }
        *cell = acc;
        if (ARGS) sar[(p * T + r) * SW + c] = arg;
      }
      __syncthreads();
    }

    for (int row = warp; row < P * tr; row += warps) {   // the tile back, as rows
      const int pp = row / tr, rr = row - pp * tr;
      const long long g = pp * N + (long long)(I0 + rr) * C + J0;
      for (int c = lane; c < tc; c += 32) {
        st[g + c] = sst[(pp * TH + HI + rr) * S1 + HJ + c];
        if (ARGS) ar[g + c] = sar[(pp * T + rr) * SW + c];
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      st_release(flags + b * nI * nJ + (long long)I * nJ + J, 1);
    }
  }
}

// rtab: starts[P+1], then per rule (grouped by target plane, declaration
// order) its index r, left plane B, right plane C: three arrays of NR ints.
template <bool MIN, bool ARGS>
__global__ void grid_spandiag_kernel(const float* __restrict__ rw_all,
                                     const float* __restrict__ init_all,
                                     const int* __restrict__ rtab,
                                     float* st_all, int* ar_all, int P, int n,
                                     int NR) {
  extern __shared__ int smem[];
  const int tab = P + 1 + 3 * NR;
  for (int k = threadIdx.x; k < tab; k += blockDim.x) smem[k] = rtab[k];
  __syncthreads();
  const int* start = smem;
  const int* rr = smem + P + 1;
  const int* rb = rr + NR;
  const int* rc = rb + NR;
  float* rws = reinterpret_cast<float*>(smem + tab);

  const long long cells = (long long)n * (n + 1) / 2;
  const long long b = blockIdx.x;
  for (int k = threadIdx.x; k < NR; k += blockDim.x)
    rws[k] = rw_all[b * NR + rr[k]];
  const float* init = init_all + b * P * n;
  float* st = st_all + b * P * cells;
  int* ar = ARGS ? ar_all + b * P * cells : nullptr;
  const float zero = MIN ? INFINITY : -INFINITY;

  for (long long idx = threadIdx.x; idx < P * cells; idx += blockDim.x) {
    const long long p = idx / cells, c = idx % cells;
    st[idx] = c < n ? init[p * n + c] : zero;
    if (ARGS) ar[idx] = -1;
  }
  __syncthreads();

  for (int d = 1; d < n; ++d) {
    const int lanes = n - d;
    const long long off_d = diag_off(d, n);
    for (int idx = threadIdx.x; idx < P * lanes; idx += blockDim.x) {
      const int A = idx / lanes, i = idx % lanes;
      const int k0 = start[A], k1 = start[A + 1];
      if (k0 == k1) continue;  // untargeted plane: zero, -1 from above
      float acc = zero;
      int arg = rr[k0];
      for (int e = 0; e < d; ++e) {
        const long long lo = diag_off(e, n) + i;
        const long long ro = diag_off(d - e - 1, n) + e + 1 + i;
        for (int k = k0; k < k1; ++k) {
          const float v = __fadd_rn(
              __fadd_rn(st[rb[k] * cells + lo], st[rc[k] * cells + ro]), rws[k]);
          if (improves<MIN>(v, acc)) {
            acc = v;
            arg = e * NR + rr[k];
          }
        }
      }
      st[A * cells + off_d + i] = acc;
      if (ARGS) ar[A * cells + off_d + i] = arg;
    }
    __syncthreads();
  }
}

int threads_for(long long lanes) {
  long long t = ((lanes + 31) / 32) * 32;
  return t > 1024 ? 1024 : (int)t;
}

using AntidiagKernel = void (*)(const float*, const float*, const float*, const int*,
                                float*, int*, int*, int, int, int, int, int, TilePlan);

AntidiagKernel antidiag_kernel(int is_min, int with_args) {
  if (is_min)
    return with_args ? grid_antidiag_kernel<true, true> : grid_antidiag_kernel<true, false>;
  return with_args ? grid_antidiag_kernel<false, true> : grid_antidiag_kernel<false, false>;
}

}  // namespace

// CTAs of the antidiag variant (is_min, with_args) at `threads` threads and
// `smem` bytes of dynamic shared memory that one SM keeps resident at once
// (occupancy API), or 0 if the card refuses the query.
extern "C" int grid_antidiag_blocks_per_sm(int is_min, int with_args, int threads,
                                           long long smem) {
  AntidiagKernel kernel = antidiag_kernel(is_min, with_args);
  int per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    (size_t)smem) != cudaSuccess)
    return 0;
  return per_sm;
}

// w (batch, L, R, C), init and pm (batch, P, R, C): f32, row-major; mtab
// int32 (P+1+4L); st (batch, P, R, C) f32 and args (same shape) int32 or
// null; sync int32 (1 + batch * tiles), zero. The tile plan (T, HI, HJ,
// S1, SW, tab ints), threads, the grid (at most
// grid_antidiag_blocks_per_sm x SMs) and the dynamic shared memory come
// from the wrapper. A cooperative launch: a grid the card cannot keep
// resident is refused (cudaErrorCooperativeLaunchTooLarge). Returns the
// first non-zero cudaError_t.
extern "C" int grid_antidiag_launch(const void* w, const void* init,
                                    const void* pm, const void* mtab, void* st,
                                    void* args, void* sync, int batch, int P,
                                    int R, int C, int L, int is_min, int T,
                                    int HI, int HJ, int S1, int SW, int tab,
                                    int threads, int ctas, int smem,
                                    void* stream) {
  AntidiagKernel kernel = antidiag_kernel(is_min, args != nullptr);
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const float* wf = static_cast<const float*>(w);
  const float* ini = static_cast<const float*>(init);
  const float* pmf = static_cast<const float*>(pm);
  const int* mt = static_cast<const int*>(mtab);
  float* out = static_cast<float*>(st);
  int* ar = static_cast<int*>(args);
  int* sy = static_cast<int*>(sync);
  TilePlan tp{T, HI, HJ, S1, SW, tab};
  void* params[] = {&wf, &ini, &pmf, &mt, &out, &ar, &sy, &batch, &P, &R, &C, &L, &tp};
  rc = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(ctas),
                                   dim3(threads), params, (size_t)smem,
                                   static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// rw (batch, NR) f32; init (batch, P, n) f32; rtab int32 (P+1+3NR); st
// (batch, P, n(n+1)/2) f32 and args (same shape) int32 or null, diagonal-major
// per plane. Returns the first non-zero cudaError_t.
extern "C" int grid_spandiag_launch(const void* rw, const void* init,
                                    const void* rtab, void* st, void* args,
                                    int batch, int P, int n, int NR,
                                    int is_min, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for((long long)P * (n - 1));
  const size_t smem = sizeof(int) * (P + 1 + 3 * (size_t)NR) + sizeof(float) * NR;
  const float* rwf = static_cast<const float*>(rw);
  const float* ini = static_cast<const float*>(init);
  const int* tab = static_cast<const int*>(rtab);
  float* out = static_cast<float*>(st);
  int* ar = static_cast<int*>(args);
  void (*kernel)(const float*, const float*, const int*, float*, int*, int, int,
                 int);
  if (is_min)
    kernel = ar ? grid_spandiag_kernel<true, true> : grid_spandiag_kernel<true, false>;
  else
    kernel = ar ? grid_spandiag_kernel<false, true> : grid_spandiag_kernel<false, false>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<batch, threads, smem, s>>>(rwf, ini, tab, out, ar, P, n, NR);
  return static_cast<int>(cudaGetLastError());
}
