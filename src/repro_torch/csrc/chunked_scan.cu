// Gated linear scan h_t = decay_t * h_{t-1} + x_t, hand-written for Hopper
// (K8).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/chunked_scan.py::chunked_scan_pallas (body: _kernel).
//
// x, decay, h_all (T, D) and h0, h_last (D,), float32, contiguous. Each
// feature's state runs one chain of fused multiply-adds in row order,
// h = __fmaf_rn(decay, h, x), as XLA's CPU compiler contracts the
// reference's d*h + x and as the plain version computes it
// (core.semiring.fma_f32): kernel, plain version and reference are
// bit-equal. A scan split into chunks would reassociate that chain, so
// the chain stays serial and the design feeds it instead.
//
// What bounds it on this card: bytes (3 T D floats moved, 2 operations per
// element): at T = 32768, D = 2048, 805 MB, 0.24 ms at 3.35 TB/s. The chain
// itself (T dependent FMAs, ~4 clocks each) takes ~75 us, so the kernel
// must keep enough loads in flight: ~3.35 TB/s x ~1 us over the card.
//
// Mapping (kernels/chunked_scan.py::plan): a CTA of two warps takes F
// neighbouring features. Warp 1, the producer, keeps a ring of S stages of
// ROWS x F tiles of x and decay in flight, each stage with a full and an
// empty mbarrier; warp 0, the consumer, runs the F chains (one a lane),
// reading a stage's rows into registers ahead of the chain (they do not
// depend on h), and releases the stage. Two staging modes, picked by the
// plan:
//   * TMA (D % 4 == 0 and 16-byte-aligned pointers): one thread issues a
//     2-D cp.async.bulk.tensor per tile, completing on the full barrier by
//     transaction count; h rows go into one of two shared-memory tiles
//     that a TMA store sends back (out-of-range rows and features are
//     clipped by the tensor map).
//   * cp.async (any D and alignment): every producer lane issues 4-byte
//     cp.async copies of its share of the tile and arrives on the full
//     barrier when they land (cp.async.mbarrier.arrive.noinc); h rows are
//     stored straight from registers.
// D = 2048 gives 128 CTAs of 16 features, ~48 KB in flight on each SM.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;          // rows of one stage
constexpr int UNROLL = 16;        // rows of x and decay in registers ahead of the chain
constexpr int THREADS = 64;       // warp 0 consumer, warp 1 producer
constexpr int MAX_STAGES = 16;
constexpr int SMEM_OPTIN = 232448;
constexpr int MAP_ERROR = 1000;   // + CUresult of a failed tensor-map encode

// Bytes of the 2S mbarriers, padded to 128 (the rings' alignment).
__host__ __device__ int bar_bytes(int S) { return (16 * S + 127) / 128 * 128; }

// Bytes of one CTA's shared memory: the mbarriers, the x and decay rings,
// and (TMA mode) two output tiles (kernels/chunked_scan.py::smem_bytes
// mirrors it).
long long smem_bytes(int F, int S, bool tma) {
  const long long tile = 4LL * ROWS * F;
  return bar_bytes(S) + 2LL * S * tile + (tma ? 2 * tile : 0);
}

// ---- device primitives: mbarrier, TMA, cp.async ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One box of the 2-D `map` at (feature c0, row c1) into shared memory at
// `dst`; its bytes count against `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The box at `src` in shared memory to (feature c0, row c1) of `map`.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N committed bulk stores still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Order this thread's shared-memory writes before later TMA reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}
// ---- end of device primitives ----

// One stage of a lane's chain: `rows` rows of x and decay (stride F) from
// the ring, h written to `out` (stride `out_stride`: F into the h tile,
// D straight to h_all). Full stages run software-pipelined in chunks of
// UNROLL rows: each row's FMA and store are followed by the loads of the
// same row of the next chunk, so the loads issue in the chain's stalls
// and are in registers a chunk before the chain needs them.
template <int F>
__device__ __forceinline__ float chain(const float* xr, const float* dr, float* out,
                                       long long out_stride, float h, int rows) {
  if (rows == ROWS) {
    float xv[UNROLL], dv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      xv[u] = xr[u * F];
      dv[u] = dr[u * F];
    }
#pragma unroll
    for (int r0 = 0; r0 < ROWS; r0 += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        h = __fmaf_rn(dv[u], h, xv[u]);
        out[(r0 + u) * out_stride] = h;
        if (r0 + UNROLL < ROWS) {
          xv[u] = xr[(r0 + UNROLL + u) * F];
          dv[u] = dr[(r0 + UNROLL + u) * F];
        }
      }
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      h = __fmaf_rn(dr[r * F], h, xr[r * F]);
      out[r * out_stride] = h;
    }
  }
  return h;
}

template <int F, bool TMA>
__global__ void __launch_bounds__(THREADS)
chunked_scan_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap dmap,
                    const __grid_constant__ CUtensorMap hmap, const float* __restrict__ x,
                    const float* __restrict__ decay, const float* __restrict__ h0,
                    float* __restrict__ h_all, float* __restrict__ h_last, int T, int D,
                    int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);     // full[S], empty[S]
  float* xs = reinterpret_cast<float*>(smem + bar_bytes(S));
  constexpr int tile = ROWS * F;
  float* ds = xs + S * tile;
  float* outs = ds + S * tile;                           // TMA: two h tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f0 = blockIdx.x * F;
  const int nst = (T + ROWS - 1) / ROWS;
  auto full = [&](int s) { return smem_addr(bars + s); };
  auto empty = [&](int s) { return smem_addr(bars + S + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), TMA ? 1 : 32);
      mbar_init(empty(s), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 1) {            // producer: lane 0 alone in TMA mode, the warp in cp.async
    if (TMA && lane > 0) return;
    for (int s = 0; s < nst; ++s) {
      const int slot = s % S;
      const uint32_t parity = (s / S) & 1;
      mbar_wait(empty(slot), parity ^ 1);
      const int t0 = s * ROWS;
      if (TMA) {
        mbar_expect_tx(full(slot), 2 * 4 * tile);
        tma_load(smem_addr(xs + slot * tile), &xmap, full(slot), f0, t0);
        tma_load(smem_addr(ds + slot * tile), &dmap, full(slot), f0, t0);
      } else {
        for (int e = lane; e < tile; e += 32) {
          const int r = e / F, c = e - r * F;
          if (t0 + r < T && f0 + c < D) {
            const long long g = (long long)(t0 + r) * D + f0 + c;
            cp_async4(smem_addr(xs + slot * tile + e), x + g);
            cp_async4(smem_addr(ds + slot * tile + e), decay + g);
          }
        }
        cp_async_arrive(full(slot));
      }
    }
    return;
  }

  // consumer: lane f < F runs feature f0 + f
  const int f = f0 + lane;
  const bool live = lane < F && f < D;
  float h = live ? h0[f] : 0.0f;
  for (int s = 0; s < nst; ++s) {
    const int slot = s % S;
    mbar_wait(full(slot), (s / S) & 1);
    const float* xr = xs + slot * tile + lane;
    const float* dr = ds + slot * tile + lane;
    const int t0 = s * ROWS, rows = min(ROWS, T - t0);
    if (TMA) {                     // the store that last read this h tile is done
      if (lane == 0) bulk_wait_read<1>();
      __syncwarp();
    }
    if (TMA && lane < F) {
      float* hs = outs + (s & 1) * tile + lane;
      h = chain<F>(xr, dr, hs, F, h, rows);
    } else if (!TMA && live) {
      float* hg = h_all + (long long)t0 * D + f;
      h = chain<F>(xr, dr, hg, D, h, rows);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(slot));
    if (TMA) {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        tma_store(&hmap, smem_addr(outs + (s & 1) * tile), f0, t0);
        bulk_commit();
      }
    }
  }
  if (TMA && lane == 0) bulk_wait_all();
  if (live) h_last[f] = h;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (no link
// against libcuda); null if the installed libcuda lacks it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 2-D map (D, T) of a float32 (T, D) row-major tensor, in boxes of F
// features x ROWS rows; out-of-range elements load as zero, stores clip.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int T, int D,
                  int F) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(F), static_cast<cuuint32_t>(ROWS)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

bool valid_plan(int F, int S, bool tma) {
  return (F == 8 || F == 16 || F == 32) && S >= 1 && S <= MAX_STAGES &&
         smem_bytes(F, S, tma) <= SMEM_OPTIN;
}

}  // namespace

// Rows of one stage (the plan's stage rows).
extern "C" int chunked_scan_rows() { return ROWS; }

// Dynamic shared memory of one CTA of a plan; -1 if the kernel does not
// take the plan.
extern "C" long long chunked_scan_smem_bytes(int F, int S, int tma) {
  if (!valid_plan(F, S, tma != 0)) return -1;
  return smem_bytes(F, S, tma != 0);
}

// The plan: F features a CTA (8, 16 or 32), S stages, tma 1 for the TMA
// mode (then D % 4 == 0 and x, decay, h_all 16-byte aligned) or 0 for
// cp.async. Returns the launch's cudaError_t, or MAP_ERROR + libcuda's
// CUresult when a tensor map cannot be made.
extern "C" int chunked_scan_launch(const void* x, const void* decay, const void* h0,
                                   void* h_all, void* h_last, int T, int D, int F, int S,
                                   int tma, void* stream) {
  if (D <= 0) return 0;
  if (T < 0 || !valid_plan(F, S, tma != 0)) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(
      cudaMemcpyAsync(h_last, h0, 4LL * D, cudaMemcpyDeviceToDevice,
                      static_cast<cudaStream_t>(stream)));
  CUtensorMap maps[3] = {};
  if (tma) {
    if (D % 4 || reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(decay) % 16 || reinterpret_cast<uintptr_t>(h_all) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return MAP_ERROR + CUDA_ERROR_NOT_FOUND;
    CUresult r = make_map(encode, &maps[0], x, T, D, F);
    if (r == CUDA_SUCCESS) r = make_map(encode, &maps[1], decay, T, D, F);
    if (r == CUDA_SUCCESS) r = make_map(encode, &maps[2], h_all, T, D, F);
    if (r != CUDA_SUCCESS) return MAP_ERROR + static_cast<int>(r);
  }
  using Kernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, const float*, const float*,
                         const float*, float*, float*, int, int, int);
  const Kernel kernels[3][2] = {
      {chunked_scan_kernel<8, false>, chunked_scan_kernel<8, true>},
      {chunked_scan_kernel<16, false>, chunked_scan_kernel<16, true>},
      {chunked_scan_kernel<32, false>, chunked_scan_kernel<32, true>}};
  const Kernel kern = kernels[F == 8 ? 0 : F == 16 ? 1 : 2][tma ? 1 : 0];
  const long long smem = smem_bytes(F, S, tma != 0);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (D + F - 1) / F;
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(x),
      static_cast<const float*>(decay), static_cast<const float*>(h0),
      static_cast<float*>(h_all), static_cast<float*>(h_last), T, D, S);
  return static_cast<int>(cudaGetLastError());
}
