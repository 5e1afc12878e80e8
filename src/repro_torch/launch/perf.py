"""Variants of one dry-run cell and their roofline terms (port of
``repro/launch/perf.py``): re-trace one cell under named variants and
report its memory, FLOPs, collective bytes and roofline terms on the H100
(``launch/roofline.py``).

    PYTHONPATH=src python -m repro_torch.launch.perf --arch arctic-480b \\
        --cell train_4k --variants seqpar,xent128

Variants (composable with ','):
    seqpar      sequence-parallel residual stream (act_seq -> model)
    xent<N>     chunked cross-entropy chunk size
    cap1        MoE capacity factor 1.0 (no slack)
    noremat     no layer-group remat (memory for compute)
    gla<N>      SSM chunk length
    mb<N>       pin gradient-accumulation microbatches

The reference's ``flash<N>`` sets the flash-attention KV chunk through an
environment knob; the port has no such knob (K7's tiles are the kernel's
own), so it has no ``flash`` variant.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.roofline import terms


def variant_kwargs(arch: str, names) -> tuple:
    """(config overrides, rule overrides, run_cell keywords) of the named
    variants."""
    cfg_o, rule_o, kw = {}, {}, {}
    for name in names:
        if not name:
            continue
        if name == "seqpar":
            rule_o["act_seq"] = ["model"]
        elif name.startswith("xent"):
            cfg_o["xent_chunk"] = int(name[4:])
        elif name == "cap1":
            cfg_o["moe"] = dataclasses.replace(get_config(arch).moe, capacity_factor=1.0)
        elif name == "noremat":
            cfg_o["remat"] = False
        elif name.startswith("gla"):
            cfg_o["ssm"] = dataclasses.replace(get_config(arch).ssm, chunk=int(name[3:]))
        elif name.startswith("mb"):
            kw["microbatches"] = int(name[2:])
        else:
            raise SystemExit(f"unknown variant {name}")
    return cfg_o, rule_o, kw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--mesh", choices=["pod", "multipod"], default="pod")
    ap.add_argument("--variants", default="")
    ap.add_argument("--out", default="results/perf_torch.jsonl")
    args = ap.parse_args(argv)

    names = args.variants.split(",") if args.variants else []
    cfg_o, rule_o, kw = variant_kwargs(args.arch, names)
    rec = run_cell(args.arch, args.cell, multi_pod=(args.mesh == "multipod"),
                   cfg_overrides=cfg_o or None, rule_overrides=rule_o or None,
                   extra_tag=args.variants, **kw)
    rec.update(terms(rec))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec, default=str) + "\n")
    print(json.dumps({k: rec[k] for k in
                      ("arch", "cell", "mesh", "tag", "microbatches",
                       "hbm_per_device", "fits_hbm", "compute_s", "memory_s",
                       "collective_s", "dominant", "roofline_frac",
                       "useful_ratio", "mfu_bound")}, indent=1, default=str))
    return rec


if __name__ == "__main__":
    main()
