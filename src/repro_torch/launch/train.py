"""Training CLI (port of ``repro/launch/train.py``): the synthetic data
stream, the train step (loss and gradients through the model's ``train``
mode, AdamW) and checkpointing under the fault-tolerance supervisor, with
JSON-lines metrics.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
        --reduced --steps 50 --batch 8 --seq 128          # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --preset lm100m --steps 300

On the card the kernels are built before the clock starts (set-up, as
``launch/serve.py`` does), and attention's gradient runs K7b.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.dp.backends import resolve_device
from repro_torch.kernels import _build
from repro_torch.models.model import CausalLM, loss_fn
from repro_torch.optim import adamw, schedules
from repro_torch.runtime.fault_tolerance import FTConfig, Supervisor


def lm100m() -> ModelConfig:
    """~100M-param dense LM for the end-to-end example run."""
    return ModelConfig(
        name="lm100m", family="dense", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=2048, vocab_size=32000, head_dim=64,
        param_dtype=torch.float32, compute_dtype=torch.float32, xent_chunk=128)


def init_state(model: CausalLM) -> tuple:
    """(params, optimizer state): the model's own parameters, their
    gradients turned on, and zero AdamW moments."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params, adamw.init(params)


def build_step(model: CausalLM, cfg: ModelConfig, lr: float, total_steps: int):
    """``step(state, batch) -> (state, metrics)``: the loss and its
    gradients, then one AdamW step (warmup over max(10, total/20) steps,
    then cosine) in place. ``cfg`` is the model's config (the reference's
    ``build_step`` takes it). A state restored from a checkpoint (new
    tensors) is copied into the model's parameters first. Metrics: loss,
    xent, grad_norm and lr, float32 tensors on the device (no sync)."""
    if cfg != model.cfg:
        raise ValueError("build_step: cfg must be the model's config")
    opt_cfg = adamw.AdamWConfig(
        lr=schedules.warmup_cosine(lr, max(10, total_steps // 20), total_steps))
    own = dict(model.named_parameters())

    def step(state, batch):
        params, opt_state = state
        if any(params[n] is not p for n, p in own.items()):
            with torch.no_grad():
                for n, p in own.items():
                    p.copy_(params[n])
                    p.requires_grad_(True)
            params = own
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        params, opt_state, om = adamw.apply(opt_cfg, grads, opt_state, params)
        out = {"loss": loss.detach(), "xent": metrics["xent"].detach(),
               "grad_norm": om["grad_norm"], "lr": om["lr"]}
        return (params, opt_state), out

    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--preset", default=None, choices=[None, "lm100m"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--metrics", default="results/train_metrics.jsonl")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.preset == "lm100m":
        cfg = lm100m()
    else:
        cfg = get_config(args.arch or "qwen3-14b")
        if args.reduced or args.arch is None:
            cfg = cfg.reduced()
    print(f"config: {cfg.name}  params={cfg.param_count():,}")

    device = resolve_device(args.device)
    model = CausalLM.from_seed(cfg, seed=args.seed, device=device)
    state = init_state(model)
    step_fn = build_step(model, cfg, args.lr, args.steps)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed,
                       frontend_tokens=cfg.n_frontend_tokens, d_model=cfg.d_model)

    def batches(i: int):
        return to_device(data.batch(i), device)

    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    sup = Supervisor(step_fn, ckpt, FTConfig(checkpoint_every=args.ckpt_every))

    start = 0
    if args.resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        state = ckpt.restore(start, state)
        print(f"resumed from step {start}")

    if device.type == "cuda":
        _build.build_all()   # set-up, not training: nvcc at first use
    t0 = time.time()
    state, log = sup.run(state, batches, start, args.steps)
    dt = time.time() - t0

    os.makedirs(os.path.dirname(args.metrics) or ".", exist_ok=True)
    with open(args.metrics, "w") as f:
        for row in log:
            f.write(json.dumps(row) + "\n")
    first, last = log[0]["loss"], log[-1]["loss"]
    tok_s = args.batch * args.seq * len(log) / dt
    print(f"steps={len(log)} loss {first:.3f} -> {last:.3f}  "
          f"{tok_s:,.0f} tok/s  ckpts={sup.stats.checkpoints} on {device}")
    if not np.isfinite(last):
        raise RuntimeError(f"the last loss is not finite: {last}")
    return last


if __name__ == "__main__":
    main()
