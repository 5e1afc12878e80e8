"""musicgen-large [audio] — decoder-only over EnCodec tokens.

[arXiv:2306.05284; hf]. 48L, d_model=2048, 32H (kv=32 → full MHA),
d_ff=8192, vocab=2048 (EnCodec codebook). The EnCodec/conditioning frontend
is a STUB: ``input_specs()`` provides 64 precomputed frame embeddings as the
sequence prefix; the decoder autoregresses over codec tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    frontend="frame",
    n_frontend_tokens=64,
    source="arXiv:2306.05284; hf",
)
