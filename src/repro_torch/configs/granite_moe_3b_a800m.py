"""granite-moe-3b-a800m [moe] — 40 experts top-8, small per-expert FFN.

[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]. 32L, d_model=1536, 24H
(GQA kv=8), expert d_ff=512, vocab=49155. (The pool annotation lists both
"40e" and "32 experts"; we follow the primary spec: 40 experts, top-8.)
40 experts do not divide the 16-wide model axis — this arch exercises the
divisibility-fallback sharding rule (shard expert d_ff instead).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff=512),
    source="hf:ibm-granite/granite-3.0-3b-a800m-base; hf",
)
