"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave + MoE.

[arXiv:2403.19887; hf]. 72L, d_model=8192, 64H (GQA kv=8), d_ff=24576,
vocab=65536, MoE 16 experts top-2 (every other layer, as in the Jamba paper);
one attention layer per period-8 block. The Mamba mixer is implemented in the
SSD (scalar-decay-per-head) chunked form — the matmul-friendly equivalent of
Mamba-1's selective scan (DESIGN.md §2 hardware-adaptation notes); d_inner =
2·d_model with 64-wide heads, d_state=16 per the Mamba defaults.

This arch exercises the paper's technique directly: the chunked scan *is* the
blocked S-DP pipeline. Runs the long_500k cell (hybrid → sub-quadratic).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=24576, every=2, offset=1),
    # chunk=32 keeps in-chunk cumulative |log decay| within the reference
    # GLA's clip window at init scale (the port's chunked_gla has no clip;
    # see models/ssm.py)
    ssm=SSMConfig(kind="mamba", n_heads=256, d_head=64, d_state=16, chunk=32),
    attn_every=8,
    attn_offset=7,
    rope_theta=1e4,
    source="arXiv:2403.19887; hf",
)
