// Streaming S-DP solver (K3): the paper's Fig.-2 pipeline past the on-chip
// gate, with the table's horizon kept in shared memory, for Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/sdp_pipeline.py::sdp_chunked_pallas and
//   ::sdp_chunked_pallas_with_args (body: _make_chunked_kernel).
//
// Computes, for every instance b of a batch,
//   ST[i] = (+)_j ST[i - a_j] (.) w[i, j],   ST[0 .. a_1-1] preset,
// lanes folded in ascending j, a lane winning only by strict improvement,
// presets carrying -1 -- through the chunk walk of sdp_walk.cuh with the
// last a_1 + Q cells in a shared-memory ring (RING).
//
// What bounds it on this card, and what the design does about it:
//  * One-cell steps (a_k = 1: edit_distance, lcs, viterbi, knapsack): the
//    near-lane chain, one fold per cell (plus a shuffle when more than
//    offset 1 is near). Everything else -- far lanes, weight loads, the
//    ring's and the table's stores -- is taken off that chain: far lanes
//    fold in parallel before it, weights arrive a chunk ahead by cp.async,
//    finished cells leave in coalesced stores after it.
//  * Wide steps whose lanes are all far (sdp, offsets 2048 .. 1025): shared
//    memory's bandwidth (one 32-float wavefront a clock) and the issue rate
//    of the fold, some k load-compare-select triples per cell. One SM
//    takes ~1024 x 1024 of them per 1024-cell chunk; a cluster of C CTAs on
//    C SMs splits each chunk, each CTA with a replica of the ring, and
//    pays one cluster barrier per chunk instead. C is the largest of 8, 4, 2
//    that leaves each CTA at least 128 cells and of which the card can run
//    a cluster (cudaOccupancyMaxActiveClusters, sdp_chunked_max_clusters);
//    each cell's lanes split over S = 4 threads, so that 16 warps, not 4,
//    hide the loads' latency on each SM.
#include "sdp_walk.cuh"

// How many clusters of C CTAs of the kernel the card can run at once
// (sdp_walk.cuh::max_clusters); the wrapper takes the largest C with one.
extern "C" int sdp_chunked_max_clusters(int op, int weighted, int args, int C,
                                        int threads, long long smem) {
  return sdp_walk::max_clusters<true>(op, weighted != 0, args != 0, C, threads,
                                      smem);
}

// init (batch, a1) f32; weights (batch, n, k) f32 or null; runs (nruns, 4)
// int32 on the device, (a0, j0, len, 0) per maximal run of consecutive
// offsets; out (batch, n) f32; args (batch, n) int32 or null. Q: cells per
// chunk; R: ring slots (>= a1 + Q); near: 0/1/2 (sdp_walk.cuh); stage:
// weights staged in shared memory; C: CTAs per instance (a cluster when
// > 1); S: threads per cell, each folding a block of lanes (all-far
// plans, min and max); threads: per CTA (>= S * ceil(Q / C)); smem: dynamic shared memory
// bytes. op: 0 = min, 1 = max, 2 = add (no args). Returns a cudaError_t.
extern "C" int sdp_chunked_launch(const void* init, const void* weights,
                                  const void* runs, void* out, void* args,
                                  int batch, int n, int a1, int k, int nruns,
                                  int Q, int R, int near, int stage, int C,
                                  int S, int threads, int op, long long smem,
                                  void* stream) {
  sdp_walk::Args a;
  a.init = static_cast<const float*>(init);
  a.weights = static_cast<const float*>(weights);
  a.runs = static_cast<const int4*>(runs);
  a.out = static_cast<float*>(out);
  a.args = static_cast<int*>(args);
  a.n = n;
  a.a1 = a1;
  a.k = k;
  a.nruns = nruns;
  a.Q = Q;
  a.R = R;
  a.near = near;
  a.stage = stage;
  a.C = C;
  a.S = S;
  return sdp_walk::launch<true>(a, batch, threads, op, smem,
                                static_cast<cudaStream_t>(stream));
}
