"""Serving CLI: the continuous-batching engine over a reduced config,
batched requests, throughput report (port of ``repro/launch/serve.py``).
``--arch`` takes any of the ten configs (dense, MoE, hybrid, SSM).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --requests 12 --max-new 24            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.models.model import CausalLM
from repro_torch.serving import Engine, Request, Scheduler


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    model = CausalLM.from_seed(cfg, seed=args.seed, device=args.device)
    engine = Engine(model, max_batch=args.max_batch, max_len=args.max_len)
    sched = Scheduler(engine)

    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=rng.integers(4, 17)).astype(np.int32)
        sched.submit(Request(rid=rid, prompt=prompt, max_new_tokens=args.max_new))

    if model.device.type == "cuda":
        _build.build_all()   # set-up, not serving: nvcc at first use
    t0 = time.time()
    done = sched.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    total_new = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:,.0f} tok/s, {engine.steps_run} engine steps) "
          f"on {model.device}")
    if len(done) != args.requests:
        raise RuntimeError(f"served {len(done)} of {args.requests} requests")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out[:8]}...")
    return done


if __name__ == "__main__":
    main()
