"""Runtime substrate (port of ``repro/runtime``): fault tolerance. The
sharding, elastic and pipeline-parallel modules wait for the sharding
slice (ROADMAP queue 1)."""
