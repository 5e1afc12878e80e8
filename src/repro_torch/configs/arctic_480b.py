"""arctic-480b [moe] — 128 experts top-2 with a dense residual branch.

[hf:Snowflake/snowflake-arctic-base; hf]. 35L, d_model=7168, 56H (GQA kv=8),
expert d_ff=4864, vocab=32000. Every layer runs the dense FFN in parallel
with the MoE branch (Arctic's dense-MoE hybrid residual design).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff=4864, dense_residual=True),
    source="hf:Snowflake/snowflake-arctic-base; hf",
)
