"""Tree helpers (port of ``repro/utils``)."""
