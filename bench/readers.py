"""Arithmetic the metric readers (``bench/metrics``) share.

Each reader is a module of its own with ``read(obs)``, where ``obs`` is
the run's ``harness.Observation``; it returns the metric's value, or None
where the run holds nothing to read it from.
"""
from __future__ import annotations

import re
import statistics

import numpy as np

from bench import roofline

#: K1 and K3 are one template, ``sdp_walk::walk_kernel<OP, WEIGHTED, ARGS,
#: RING>``, built into two libraries: K3 streams through its ring, K1 not
_WALK = re.compile(r"walk_kernel<\s*\w+\s*,\s*(true|false)\s*,\s*(true|false)\s*,\s*(true|false)\s*>")
#: the dispatch route whose drains launch each kernel
ROUTE = {"sdp_pipeline": "kernel_blocked", "sdp_chunked": "kernel_tiled"}


def kernel_of(name: str):
    """``"sdp_chunked"``, ``"sdp_pipeline"`` or None for a device
    operation's name."""
    m = _WALK.search(name)
    if m is None:
        return None
    return "sdp_chunked" if m.group(3) == "true" else "sdp_pipeline"


def span_mean_ms(obs, name: str):
    spans = obs.spans.get(name, [])
    return statistics.fmean(spans) * 1e3 if spans else None


def percentile_ms(obs, q: float):
    lat = obs.latencies_ms
    return float(np.percentile(lat, q)) if lat else None


def roofline_share(obs, kernel: str):
    """The least time the lanes the kernel's route solved in the traced
    window could take (``roofline.bound_s`` of their work counted from the
    instance), over the kernel's device time there, in percent."""
    if obs.trace is None:
        return None
    secs = sum(s for name, _, s in obs.trace.ops if kernel_of(name) == kernel)
    lanes = obs.lanes_by_route.get(ROUTE[kernel], 0)
    if secs <= 0 or lanes == 0:
        return None
    nbytes, ops = obs.work
    return 100.0 * roofline.bound_s(nbytes * lanes, ops * lanes)[0] / secs


def idle_share(obs):
    """The share of the traced window in which no kernel, set or copy that
    the host does not pace ran on a card, averaged over the cards, in
    percent (``trace``: a copy through pageable memory is the host's)."""
    t = obs.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s(obs.devices) / t.window_s)


def pageable_share(obs):
    """The share of the traced window in which a card copied to or from
    pageable host memory, averaged over the cards, in percent."""
    t = obs.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * t.pageable_s(obs.devices) / t.window_s
