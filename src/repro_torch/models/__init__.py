"""Model zoo (port of ``repro/models``): causal LMs for serving — dense, MoE,
hybrid (attention + Mamba) and SSM (RWKV6) blocks."""
