"""rwkv6-1.6b "Finch" [ssm] — attention-free, data-dependent decay.

[arXiv:2404.05892; unverified]. 24L, d_model=2048, d_ff=7168 (channel-mix),
vocab=65536; 32 heads of 64 (state 64×64 per head). The WKV6 recurrence
``S_t = diag(w_t) S_{t-1} + k_t v_tᵀ`` is an S-DP-style semiring recurrence
and is evaluated with the chunked pipeline scan (DESIGN.md §3) — per-channel
vector decay + the u-bonus current-token term. Runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,           # unused by the mixer (attn-free) but kept for shape rules
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,
    ssm=SSMConfig(kind="rwkv6", n_heads=32, d_head=64, d_state=64, chunk=32),
    attn_every=0,          # never attention
    source="arXiv:2404.05892; unverified",
)
