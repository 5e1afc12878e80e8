"""qwen3-14b [dense] — GQA kv=8 with per-head q/k RMS-norm (qk_norm).

[hf:Qwen/Qwen3-14B; hf]. 40L, d_model=5120, 40H (GQA kv=8), d_ff=17408,
vocab=151936, head_dim=128, rope_theta=1e6. The 152k vocab makes this the
chunked-xent stress arch. (The reference's copy labels these numbers
Qwen3-8B; they are Qwen3-14B's.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-14B; hf",
)
