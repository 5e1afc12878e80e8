// Blocked pipelined S-DP solver (K1), the paper's Fig. 2 with the table
// resident in device memory, for Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/sdp_pipeline.py::sdp_pipeline_pallas and
//   ::sdp_pipeline_pallas_with_args (body: _make_kernel).
//
// Computes, for every instance b of a batch,
//   ST[i] = (+)_j ST[i - a_j] (.) w[i, j],   ST[0 .. a_1-1] preset,
// lanes folded in ascending j, a lane winning only by strict improvement,
// presets carrying -1 -- through the chunk walk of sdp_walk.cuh, one CTA
// (or one cluster) per instance. K1 is the route for specs within the
// on-chip gate (the card's L2), so it keeps the whole table in device
// memory: far lanes read the finished cells through L1 and L2, where the
// chunk's a_1 + Q cell window stays; each thread issues a run's loads four
// ahead of its compares. Near lanes run in one warp, as in K3; weights are
// staged a chunk ahead by cp.async.
//
// What bounds it on this card, and what the design does about it:
//  * One-cell steps (edit_distance, lcs, knapsack at a_k = 1): the
//    near-lane chain, one fold per cell; far lanes, weight loads and the
//    table's stores are off it (sdp_walk.cuh).
//  * Wide all-far steps (sdp 2^20, offsets 2048 .. 1025): on one SM, the
//    load path and the issue rate of the fold, k load-compare-select
//    triples per cell. As in K3, a cluster of C CTAs splits each chunk;
//    each CTA writes its cells to the table in device memory, the cluster
//    barrier's release/acquire makes them visible to its peers, and the far
//    loads go to L2 past L1 (ld.global.cg), where no SM keeps a stale line
//    of a peer's cells. On one CTA they read through L1.
#include "sdp_walk.cuh"

// How many clusters of C CTAs of the kernel the card can run at once
// (sdp_walk.cuh::max_clusters); the wrapper takes the largest C with one.
extern "C" int sdp_pipeline_max_clusters(int op, int weighted, int args, int C,
                                         int threads, long long smem) {
  return sdp_walk::max_clusters<false>(op, weighted != 0, args != 0, C,
                                       threads, smem);
}

// init (batch, a1) f32; weights (batch, n, k) f32 or null; runs (nruns, 4)
// int32 on the device, (a0, j0, len, 0) per maximal run of consecutive
// offsets; out (batch, n) f32; args (batch, n) int32 or null. Q: cells per
// chunk; near: 0/1/2 (sdp_walk.cuh); stage: weights staged in shared
// memory; C: CTAs per instance (a cluster when > 1); S: threads per cell,
// each folding a block of lanes (all-far plans, min and max); threads: per
// CTA (>= S * ceil(Q / C)); smem: dynamic shared memory bytes. op: 0 = min,
// 1 = max, 2 = add (no args). Returns a cudaError_t.
extern "C" int sdp_pipeline_launch(const void* init, const void* weights,
                                   const void* runs, void* out, void* args,
                                   int batch, int n, int a1, int k, int nruns,
                                   int Q, int near, int stage, int C,
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
  a.R = 0;
  a.near = near;
  a.stage = stage;
  a.C = C;
  a.S = S;
  return sdp_walk::launch<false>(a, batch, threads, op, smem,
                                 static_cast<cudaStream_t>(stream));
}
