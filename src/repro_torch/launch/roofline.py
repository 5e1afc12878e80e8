"""Roofline terms of a dry-run record on the H100 (the port's copy of
``benchmarks/roofline.py::{model_flops, terms}``, with the card's rates).

    compute_s    = per-device FLOPs / 989e12          (bf16 tensor cores)
    memory_s     = per-device op-boundary HBM traffic / 3.35e12
    collective_s = per-device collective output bytes (×2 for all-reduce,
                   ring cost) / 450e9                  (NVLink, one direction)

The link rate is NVLink's within one 8-card board; a mesh axis that spans
boards (the 16 × 16 mesh's every axis) crosses the slower network between
them, so ``collective_s`` is optimistic there.

Derived:
    bound_s       = max of the three (step-time lower bound)
    dominant      = argmax
    roofline_frac = compute_s / bound_s (1.0 ⇔ compute-bound)
    model_flops   = 6·N·D (dense) or 6·N_active·D (MoE) train; 2·N·D serve
    mfu_bound     = model_flops / chips / 989e12 / bound_s
    useful_ratio  = model_flops / (chips · FLOPs) (remat and overhead)
"""
from __future__ import annotations

#: H100 SXM (NVIDIA data sheet, dense, 700 W): bf16 FLOP/s, HBM bytes/s,
#: NVLink bytes/s in one direction
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

AR_FACTOR = 2.0          # ring all-reduce moves ~2x payload per device


def model_flops(rec: dict) -> float:
    """6·N_active·D for train (fwd+bwd), 2·N_active·D for prefill/decode
    (decode: one token a sequence), D from the record's cell shape."""
    n_act = rec["active_param_count"]
    if rec["kind"] == "train":
        return 6.0 * n_act * rec["global_batch"] * rec["seq_len"]
    if rec["kind"] == "prefill":
        return 2.0 * n_act * rec["global_batch"] * rec["seq_len"]
    return 2.0 * n_act * rec["global_batch"]


def terms(rec: dict) -> dict:
    chips = rec["devices"]
    comp = rec["flops"] / PEAK_FLOPS
    mem = rec.get("hbm_traffic_bytes", 0.0) / HBM_BW
    coll = rec["collectives"]
    coll_bytes = (AR_FACTOR * coll.get("all-reduce", 0)
                  + coll.get("all-gather", 0) + coll.get("reduce-scatter", 0)
                  + coll.get("all-to-all", 0) + coll.get("collective-permute", 0))
    link = coll_bytes / LINK_BW
    bound = max(comp, mem, link, 1e-12)
    dom = {comp: "compute", mem: "memory", link: "collective"}[max(comp, mem, link)]
    mf = model_flops(rec)
    return {
        "compute_s": comp, "memory_s": mem, "collective_s": link,
        "bound_s": bound, "dominant": dom,
        "roofline_frac": comp / bound,
        "model_flops": mf,
        "useful_ratio": mf / max(chips * rec["flops"], 1e-9),
        "mfu_bound": mf / chips / PEAK_FLOPS / bound,
    }
