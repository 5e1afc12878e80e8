"""Recurrence solvers: the S-DP family (``sdp``) and the triangular split
family (``mcm``), over the algebra in ``semiring``."""
