"""Quickstart on PyTorch: the paper's two DP solvers through the port.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import blocked_mcm, mcm, sdp
from repro_torch.core.planner import contract_chain, plan_chain


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    # --- 1. S-DP problem (Def. 1): Fibonacci as the paper's own example ----
    init = torch.tensor([1.0, 1.0], dtype=torch.float64, device=dev)
    fib = sdp.solve_pipeline(init, (2, 1), "add", 20)
    print("Fibonacci via Fig.-2 pipeline:",
          fib[:10].cpu().numpy().astype(int).tolist())

    # --- 2. S-DP with min (the paper's experimental setting) ----------------
    offsets = (5, 3, 1)
    init = torch.tensor([10.0, 20.0, 30.0, 40.0, 50.0], device=dev)
    st = sdp.solve_blocked(init, offsets, "min", 32)
    print(f"S-DP min, {sdp.pipeline_num_steps(32, offsets)} pipeline steps:",
          st[-5:].cpu().numpy())

    # --- 3. MCM problem (§IV): optimal matrix-chain parenthesization --------
    dims = np.array([30.0, 35, 15, 5, 10, 20, 25])  # CLRS example
    table = mcm.solve_mcm_pipeline(dims, order="safe")
    print("MCM optimal cost (CLRS 15.2 expects 15125):", int(table[-1]))

    # --- 4. The blocked tropical-GEMM solver (beyond-paper) -----------------
    n = 32
    rng = np.random.default_rng(0)
    big = rng.integers(1, 40, size=n + 1).astype(np.float64)
    m = blocked_mcm.solve_blocked(torch.tensor(big, dtype=torch.float32,
                                               device=dev), n, 8)
    ref = mcm.mcm_reference(big)[0]
    print("blocked MCM matches oracle:",
          bool(np.allclose(m.cpu().numpy()[0, n - 1], ref[0, n - 1])))

    # --- 5. The MCM planner inside the framework ----------------------------
    shapes = [(64, 512), (512, 16), (16, 256), (256, 32)]
    plan = plan_chain(shapes)
    mats = [torch.tensor(rng.normal(size=s), dtype=torch.float32, device=dev)
            for s in shapes]
    out = contract_chain(mats, plan)
    print(f"einsum-chain planner: optimal {plan.flops:.0f} flops vs naive "
          f"{plan.naive_flops:.0f} ({plan.naive_flops / plan.flops:.1f}x), "
          f"result shape {tuple(out.shape)}")


if __name__ == "__main__":
    main()
