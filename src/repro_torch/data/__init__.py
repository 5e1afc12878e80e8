"""Data substrate (port of ``repro/data``)."""
