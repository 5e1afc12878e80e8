"""Runtime substrate (port of ``repro/runtime``): fault tolerance,
rule-based sharding over a mesh of slots, elastic re-meshing and pipeline
parallelism."""
