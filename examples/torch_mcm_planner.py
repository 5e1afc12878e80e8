"""Example: DP planners as framework services — chain ordering for real
attention/LoRA projection chains and DP-balanced pipeline stages, on the
port (numpy planners; the chain is contracted on ``--device``).

    PYTHONPATH=src python examples/torch_mcm_planner.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.planner import contract_chain, partition_stages, plan_chain


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    # --- 1. LoRA-chain ordering ---------------------------------------------
    # x (tokens × d) @ A (d × r) @ B (r × d) — MCM decides (xA)B vs x(AB)
    tokens, d, r = 8192, 4096, 16
    plan = plan_chain([(tokens, d), (d, r), (r, d)])
    print(f"LoRA chain: optimal={plan.flops:.3e} naive={plan.naive_flops:.3e} "
          f"tree={plan.tree}")
    g = torch.Generator(device=dev).manual_seed(0)
    mats = [torch.randn(s, generator=g, device=dev) / 64
            for s in [(256, 512), (512, r), (r, 512)]]
    out = contract_chain(mats, plan_chain([tuple(m.shape) for m in mats]))
    print(f"  contracted a 256-token chain on {dev}: shape {tuple(out.shape)}")

    # --- 2. Attention-score chain for a small batch -------------------------
    # q (s × dh) @ K^T (dh × s) @ v (s × dh): MCM picks the cheaper association
    for s, dh in [(128, 512), (4096, 64)]:
        p = plan_chain([(s, dh), (dh, s), (s, dh)])
        order = "(qK)v" if p.tree[1][0] == "mul" else "q(Kv)"
        print(f"s={s} dh={dh}: {order} flops={p.flops:.3e} "
              f"(naive {p.naive_flops:.3e})")

    # --- 3. Pipeline-stage partitioning over a real config ------------------
    cfg = get_config("jamba-1.5-large-398b")
    costs = []
    for i in range(cfg.n_layers):
        c = 1.0 if cfg.mixer_of(i) == "attn" else 0.7   # relative layer cost
        c += 3.0 if cfg.mlp_of(i) == "moe" else 1.0
        costs.append(c)
    bounds, bottleneck = partition_stages(costs, 8)
    sizes = np.diff([0, *bounds, len(costs)])
    print(f"jamba → 8 pipeline stages: layer counts {sizes.tolist()}, "
          f"bottleneck stage cost {bottleneck:.1f} "
          f"(uniform split would be "
          f"{max(np.add.reduceat(costs, np.arange(0, 72, 9))):.1f})")


if __name__ == "__main__":
    main()
