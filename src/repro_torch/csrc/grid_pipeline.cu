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
// one anti-diagonal front t = i + j per step, t = 1 .. R+C-2. Every move
// steps strictly forward (di + dj >= 1), so every source lies on an earlier
// front and all planes of a front are independent. The buffers arrive in
// frontier-major order (the wrapper permutes them): front t is the
// contiguous run [base(t), base(t) + len(t)), lane j at base(t) + j - c0(t),
// and a move's sources for consecutive lanes are consecutive too, so every
// warp-wide load and store touches contiguous words. A move whose source is
// outside the grid contributes nothing and reads nothing; a preset cell
// takes init and arg -1; a plane no move targets keeps init where preset
// and the semiring zero elsewhere, with args -1; front 0 is cell (0, 0),
// which no move reaches, and keeps that initial value too.
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
// Mapping: one CTA per instance (grid = batch), __syncthreads() between
// fronts / diagonals; the per-plane move or rule lists and the rule
// weights live in shared memory. Tables stay in device memory (gotoh at
// 4096 x 4096 is 1.3 GB); L2 holds the recent fronts that the sources come
// from. Offsets into the tables are 64-bit: batch * L * R * C weights pass
// 2^31 in a batch of gotoh at 4096^2.
//
// What bounds it on this card: the byte bound is the inputs once plus the
// outputs once (0.38 ms at gotoh 4096^2), but one CTA runs on one of the
// 132 SMs and the R+C-1 fronts are a serial chain of barriers, so the
// kernel is bound by one SM's load throughput and the per-front latency
// (PERF.md). Spreading one instance over many SMs and staging fronts in
// shared memory are later work.
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

// mtab: starts[P+1], then per move (grouped by target plane, declaration
// order) its index l, source plane, di, dj: four arrays of L ints.
template <bool MIN, bool ARGS>
__global__ void grid_antidiag_kernel(const float* __restrict__ w_all,
                                     const float* __restrict__ init_all,
                                     const float* __restrict__ pm_all,
                                     const int* __restrict__ mtab,
                                     float* st_all, int* ar_all, int P, int R,
                                     int C, int L) {
  extern __shared__ int smem[];
  const int tab = P + 1 + 4 * L;
  for (int k = threadIdx.x; k < tab; k += blockDim.x) smem[k] = mtab[k];
  __syncthreads();
  const int* start = smem;
  const int* ml = smem + P + 1;
  const int* mf = ml + L;
  const int* mdi = mf + L;
  const int* mdj = mdi + L;

  const long long N = (long long)R * C;
  const long long b = blockIdx.x;
  const float* w = w_all + b * L * N;
  const float* init = init_all + b * P * N;
  const float* pm = pm_all + b * P * N;
  float* st = st_all + b * P * N;
  int* ar = ARGS ? ar_all + b * P * N : nullptr;
  const float zero = MIN ? INFINITY : -INFINITY;

  for (int t = 0; t < R + C - 1; ++t) {
    const int c0 = t - R + 1 > 0 ? t - R + 1 : 0;
    const int c1 = t < C - 1 ? t : C - 1;
    const long long base = front_base(t, R, C);
    for (int j = c0 + threadIdx.x; j <= c1; j += blockDim.x) {
      const int i = t - j;
      const long long pos = base + (j - c0);
      for (int p = 0; p < P; ++p) {
        const long long cell = p * N + pos;
        const bool preset = pm[cell] > 0.0f;
        const int k0 = start[p], k1 = start[p + 1];
        float acc = preset ? init[cell] : zero;
        int arg = -1;
        if (!preset && t > 0 && k0 < k1) {
          arg = ml[k0];
          for (int k = k0; k < k1; ++k) {
            const int di = mdi[k], dj = mdj[k];
            if (i < di || j < dj) continue;  // source outside the grid
            const long long ts = t - di - dj;
            const long long src =
                front_base(ts, R, C) + (j - dj) - (ts - R + 1 > 0 ? ts - R + 1 : 0);
            const float v =
                __fadd_rn(st[mf[k] * N + src], w[ml[k] * N + pos]);
            if (improves<MIN>(v, acc)) {
              acc = v;
              arg = ml[k];
            }
          }
        }
        st[cell] = acc;
        if (ARGS) ar[cell] = arg;
      }
    }
    __syncthreads();
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

}  // namespace

// w (batch, L, R*C), init and pm (batch, P, R*C): f32, frontier-major;
// mtab int32 (P+1+4L); st (batch, P, R*C) f32 and args (batch, P, R*C) int32
// or null, frontier-major. Returns the first non-zero cudaError_t.
extern "C" int grid_antidiag_launch(const void* w, const void* init,
                                    const void* pm, const void* mtab, void* st,
                                    void* args, int batch, int P, int R, int C,
                                    int L, int is_min, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(R < C ? R : C);
  const size_t smem = sizeof(int) * (P + 1 + 4 * (size_t)L);
  const float* wf = static_cast<const float*>(w);
  const float* ini = static_cast<const float*>(init);
  const float* pmf = static_cast<const float*>(pm);
  const int* tab = static_cast<const int*>(mtab);
  float* out = static_cast<float*>(st);
  int* ar = static_cast<int*>(args);
  void (*kernel)(const float*, const float*, const float*, const int*, float*,
                 int*, int, int, int, int);
  if (is_min)
    kernel = ar ? grid_antidiag_kernel<true, true> : grid_antidiag_kernel<true, false>;
  else
    kernel = ar ? grid_antidiag_kernel<false, true> : grid_antidiag_kernel<false, false>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<batch, threads, smem, s>>>(wf, ini, pmf, tab, out, ar, P, R, C, L);
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
