"""Model zoo (port of ``repro/models``): dense causal LMs for serving."""
