"""internvl2-76b [vlm] — InternViT frontend (STUB) + InternLM2 backbone.

[arXiv:2404.16821; unverified]. Backbone: 80L, d_model=8192, 64H (GQA kv=8),
d_ff=28672, vocab=128256. Per the assignment, only the transformer BACKBONE
is modeled; the ViT frontend is a stub — ``input_specs()`` supplies 256
precomputed patch embeddings that replace the first 256 sequence positions,
and the loss is masked to text positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    frontend="patch",
    n_frontend_tokens=256,
    source="arXiv:2404.16821; unverified",
)
