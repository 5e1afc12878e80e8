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
// one span diagonal d per step, d = 1 .. n-1, spread over the whole card:
// a persistent cooperative grid (as many CTAs as the card keeps resident,
// from the occupancy API; a larger grid is refused, never hung), a grid
// barrier (grid_sync.cuh) between diagonals. A diagonal's (instance,
// targeted plane, cell) triples are dealt out to groups of g warps (g =
// spandiag_warps: as many as a triple's candidates fill, as long as every
// triple still gets a group), consecutive triples to consecutive CTAs. A
// triple's candidates (split e, rule r into A), e-major and the rules in
// declaration order, so in ascending packed key e*NR + r, are dealt to the
// group's lanes in turn; each lane folds its own in ascending order, then
// the group merges by (value, key): the first best candidate, the
// sequential fold's. Operands come from a cell-major copy of the chart
// (every plane of a cell contiguous, scratch the wrapper allocates: as
// large as the table), so a warp's loads at one split touch one or two
// cells' rows; finished cells go to the table and the copy, and are read
// past L1 (ld.global.cg), as other SMs wrote them. The rule table stays in
// shared memory; rule weights are read through the read-only cache.
// Diagonal 0 is preset from init (args -1); a plane no rule targets stays
// at the semiring zero with args -1.
//
// Both fold with strict improvement from the semiring zero, the arg
// starting at the first move or rule into the plane: ties keep the first
// candidate in declaration order, the first-occurrence rule of argmin /
// argmax. Sums associate as (left + right) + w with __fadd_rn, built with
// --fmad=false and no fast math. Max and min never mix +inf and -inf: the
// grid problems mask invalid moves with their own semiring zero.
//
// Mapping: both are persistent cooperative grids, antidiag over the tiles
// of the whole batch, spandiag over each diagonal's triples. The per-plane
// move or rule lists live in shared memory. Tables stay in device memory
// (gotoh at 4096 x 4096 is 1.3 GB). Offsets into the tables are 64-bit:
// batch * L * R * C weights pass 2^31 in a batch of gotoh at 4096^2.
//
// What bounds it on this card: the byte bound is the inputs once plus the
// outputs once (0.38 ms at gotoh 4096^2). antidiag's serial chain is the
// tile wavefront, about 2 (R + C) shared-memory steps of one CTA each;
// spandiag's bound is its candidates' operations (three a candidate), far
// below the n - 1 grid barriers of its diagonal chain and the L2 round
// trips of the operand loads each diagonal waits on.
#include <cuda_runtime.h>
#include <math.h>

#include "grid_sync.cuh"

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

// spandiag: threads (warps) of one CTA, CTAs the wrapper puts on one SM
// (registers are bounded for them), candidates a thread loads per batch,
// the key of "no candidate improved"
constexpr int SD_THREADS = 512;
constexpr int SD_CTAS_PER_SM = 1;   // the wrapper's grid: at most this many a SM
constexpr int SD_WARPS = SD_THREADS / 32;
constexpr int SD_PF = 4;
constexpr int NO_KEY = 0x7fffffff;

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

// Warps folding one (instance, plane, cell) triple of a span diagonal
// whose triples hold at most `cand` candidates each (`triples` of them,
// `G` CTAs): the least power of two whose lanes cover the candidates, at
// most SD_WARPS, halved while the triples would not each get a group.
// Mirrored by kernels/grid_pipeline.py::spandiag_warps.
__device__ __forceinline__ int spandiag_warps(long long cand, long long triples, int G) {
  int g = 1;
  while (g < SD_WARPS && 32LL * g < cand) g *= 2;
  while (g > 1 && triples * g > (long long)G * SD_WARPS) g /= 2;
  return g;
}

// (value, key) of a or b, whichever the semiring prefers, the smaller key
// on ties
template <bool MIN>
__device__ __forceinline__ void merge(float& v, int& k, float ov, int ok) {
  if (improves<MIN>(ov, v) || (ov == v && ok < k)) {
    v = ov;
    k = ok;
  }
}

// rtab: starts[P+1], then per rule (grouped by target plane, declaration
// order) its index r, left plane B, right plane C: three arrays of NR ints.
// cm (B, cells, P): the chart cell-major (every plane of a cell
// contiguous), scratch the kernel fills; bar: one uint32, zero at launch.
template <bool MIN, bool ARGS>
__global__ void __launch_bounds__(SD_THREADS, SD_CTAS_PER_SM)
grid_spandiag_kernel(const float* __restrict__ rw_all,
                     const float* __restrict__ init_all,
                     const int* __restrict__ rtab, float* st_all, int* ar_all,
                     float* cm_all, unsigned* bar, int B, int P, int n, int NR) {
  extern __shared__ __align__(16) int smem[];
  int4* rules = reinterpret_cast<int4*>(smem);   // NR: {r, B, C, 0}
  int* start = smem + 4 * NR;                    // P + 1
  int* live = start + P + 1;                     // targeted planes, ascending
  float* mv = reinterpret_cast<float*>(live + P);  // SD_WARPS partial values
  int* mk = reinterpret_cast<int*>(mv + SD_WARPS); // SD_WARPS partial keys
  __shared__ int n_live, most_rules;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = gridDim.x;
  for (int k = tid; k < NR; k += SD_THREADS)
    rules[k] = make_int4(rtab[P + 1 + k], rtab[P + 1 + NR + k],
                         rtab[P + 1 + 2 * NR + k], 0);
  for (int k = tid; k <= P; k += SD_THREADS) start[k] = rtab[k];
  __syncthreads();
  if (tid == 0) {
    int c = 0, most = 0;
    for (int p = 0; p < P; ++p) {
      const int rp = start[p + 1] - start[p];
      if (rp > 0) live[c++] = p;
      most = rp > most ? rp : most;
    }
    n_live = c;
    most_rules = most;
  }
  __syncthreads();
  const int PL = n_live;

  const long long cells = (long long)n * (n + 1) / 2;
  const float zero = MIN ? INFINITY : -INFINITY;
  // every cell: init on diagonal 0, the semiring zero above it (a plane no
  // rule targets keeps it), args -1; in the table and its cell-major copy
  for (long long q = (long long)blockIdx.x * SD_THREADS + tid; q < (long long)B * P * cells;
       q += (long long)G * SD_THREADS) {
    const long long bp = q / cells, c = q - bp * cells;
    const long long b = bp / P, p = bp - b * P;
    const float v = c < n ? init_all[bp * n + c] : zero;
    st_all[q] = v;
    if (ARGS) ar_all[q] = -1;
    cm_all[(b * cells + c) * P + p] = v;
  }
  unsigned phase = 0;
  grid_sync(bar, ++phase);

  for (int d = 1; d < n; ++d) {
    const int lanes = n - d;
    const long long off_d = diag_off(d, n);
    const long long triples = (long long)B * PL * lanes;
    const int g = spandiag_warps((long long)d * most_rules, triples, G);
    const int T = 32 * g;                        // threads a triple
    const long long groups = (long long)G * (SD_WARPS / g);
    const long long gid = (long long)(warp / g) * G + blockIdx.x;
    const int t = (warp % g) * 32 + lane;
    const long long rounds = (triples + groups - 1) / groups;
    for (long long r = 0; r < rounds; ++r) {
      const long long q = gid + r * groups;
      float best = zero;
      int key = NO_KEY;
      long long b = 0;
      int A = 0, i = 0, k0 = 0;
      if (q < triples) {
        b = q / ((long long)PL * lanes);
        const int rem = (int)(q - b * PL * lanes);
        A = live[rem / lanes];
        i = rem % lanes;
        k0 = start[A];
        const int RA = start[A + 1] - k0;
        const int cand = d * RA;
        // candidate k = e * RA + j (split e, j-th rule into A): this thread
        // takes k = t, t + T, ... ascending, stepping (e, j) by T
        int e = t / RA, j = t - (t / RA) * RA;
        const int se = T / RA, sj = T - se * RA;
        const float* cm = cm_all + b * cells * P;
        const float* rw = rw_all + b * NR;
        for (int k = t; k < cand; k += SD_PF * T) {
          float a[SD_PF], c[SD_PF], wv[SD_PF];
          int kk[SD_PF];
#pragma unroll
          for (int u = 0; u < SD_PF; ++u) {
            if (k + u * T < cand) {
              const int4 rl = rules[k0 + j];
              const long long lo = diag_off(e, n) + i;
              const long long ro = diag_off(d - e - 1, n) + e + 1 + i;
              a[u] = __ldcg(cm + lo * P + rl.y);
              c[u] = __ldcg(cm + ro * P + rl.z);
              wv[u] = __ldg(rw + rl.x);
              kk[u] = e * NR + rl.x;
            }
            j += sj;
            e += se;
            if (j >= RA) {
              j -= RA;
              ++e;
            }
          }
#pragma unroll
          for (int u = 0; u < SD_PF; ++u) {
            if (k + u * T < cand) {
              const float v = __fadd_rn(__fadd_rn(a[u], c[u]), wv[u]);
              if (improves<MIN>(v, best)) {
                best = v;
                key = kk[u];
              }
            }
          }
        }
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        merge<MIN>(best, key, __shfl_xor_sync(0xffffffffu, best, s),
                   __shfl_xor_sync(0xffffffffu, key, s));
      if (g > 1) {                               // uniform over the grid
        if (lane == 0) {
          mv[warp] = best;
          mk[warp] = key;
        }
        __syncthreads();
        if (t == 0)
          for (int m = 1; m < g; ++m) merge<MIN>(best, key, mv[warp + m], mk[warp + m]);
        __syncthreads();                         // mv / mk are refilled next
      }
      if (t == 0 && q < triples) {
        // nothing improved on the zero: the first rule into the plane
        const int arg = key == NO_KEY ? rules[k0].x : key;
        const long long cell = off_d + i;
        st_all[(b * P + A) * cells + cell] = best;
        if (ARGS) ar_all[(b * P + A) * cells + cell] = arg;
        cm_all[(b * cells + cell) * P + A] = best;
      }
    }
    grid_sync(bar, ++phase);                     // diagonal d is read from d + 1 on
  }
}

using SpandiagKernel = void (*)(const float*, const float*, const int*, float*, int*,
                                float*, unsigned*, int, int, int, int);

SpandiagKernel spandiag_kernel(int is_min, int with_args) {
  if (is_min)
    return with_args ? grid_spandiag_kernel<true, true> : grid_spandiag_kernel<true, false>;
  return with_args ? grid_spandiag_kernel<false, true> : grid_spandiag_kernel<false, false>;
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

// Threads of one spandiag CTA (the wrapper's plan reads it).
extern "C" int grid_spandiag_threads() { return SD_THREADS; }

// Dynamic shared memory of one spandiag CTA: the rule table ({r, B, C} a
// rule, 16 bytes), plane starts, the targeted planes, the merge slots.
extern "C" long long grid_spandiag_smem_bytes(int P, int NR) {
  return 16LL * NR + 4LL * (2 * P + 1) + 8LL * SD_WARPS;
}

// spandiag CTAs of the variant (is_min, with_args) at `smem` bytes that one
// SM keeps resident at once (occupancy API), or 0 if the card refuses the
// query.
extern "C" int grid_spandiag_blocks_per_sm(int is_min, int with_args, long long smem) {
  SpandiagKernel kernel = spandiag_kernel(is_min, with_args);
  int per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SD_THREADS,
                                                    (size_t)smem) != cudaSuccess)
    return 0;
  return per_sm;
}

// rw (batch, NR) f32; init (batch, P, n) f32; rtab int32 (P+1+3NR); st
// (batch, P, n(n+1)/2) f32 and args (same shape) int32 or null,
// diagonal-major per plane; cm (batch, n(n+1)/2, P) f32 scratch; bar one
// uint32, zero. ctas: the grid (at most grid_spandiag_blocks_per_sm x SMs).
// A cooperative launch: a grid the card cannot keep resident is refused
// (cudaErrorCooperativeLaunchTooLarge). Returns the first non-zero
// cudaError_t.
extern "C" int grid_spandiag_launch(const void* rw, const void* init,
                                    const void* rtab, void* st, void* args,
                                    void* cm, void* bar, int batch, int P, int n,
                                    int NR, int is_min, int ctas, void* stream) {
  SpandiagKernel kernel = spandiag_kernel(is_min, args != nullptr);
  const long long smem = grid_spandiag_smem_bytes(P, NR);
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const float* rwf = static_cast<const float*>(rw);
  const float* ini = static_cast<const float*>(init);
  const int* tab = static_cast<const int*>(rtab);
  float* out = static_cast<float*>(st);
  int* ar = static_cast<int*>(args);
  float* cmf = static_cast<float*>(cm);
  unsigned* b = static_cast<unsigned*>(bar);
  void* params[] = {&rwf, &ini, &tab, &out, &ar, &cmf, &b, &batch, &P, &n, &NR};
  rc = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(ctas),
                                   dim3(SD_THREADS), params, (size_t)smem,
                                   static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
