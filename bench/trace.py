"""The traced window: ``torch.profiler`` over it, read back from its
chrome trace.

The benchmark's own spans (``submit``, ``step``, ``poll``, and ``window``
around the whole measured loop) are ``record_function`` ranges, so they
share the trace's clock with the device's kernels and copies. From that
one timeline :func:`summarize` takes the window's length, each card's busy
time, each kernel's device time, the time each card spends copying into
pageable host memory, and the device's idle time by what the host was
doing.

A copy into or out of pageable host memory is paced by the host: CUDA
stages it through a pinned buffer and the host copies each piece on
its own. So it counts apart (``pageable_by_device``), and not as the
card's work: a card is busy while its kernels, sets and other copies run.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

#: trace categories that are operations on a device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the mark of a copy to or from pageable host memory in its name
PAGEABLE = "Pageable"
#: the benchmark's spans around its calls into the service (one thread
#: makes them, one after another, so they never overlap)
SPANS = ("submit", "poll", "step")


@dataclass
class TraceSummary:
    window_s: float
    #: device index -> seconds in which a kernel, a set or a copy that is
    #: not paced by the host ran there
    busy_by_device: dict
    #: (name, device, seconds) of every device operation in the window
    ops: list
    #: host span name (or "between calls") -> device idle seconds under it,
    #: summed over the devices
    idle_by_span: dict = field(default_factory=dict)
    #: device index -> seconds in which a copy to or from pageable host
    #: memory ran there
    pageable_by_device: dict = field(default_factory=dict)

    def busy_s(self, devices) -> float:
        """Busy seconds averaged over ``devices``."""
        return sum(self.busy_by_device.get(d, 0.0) for d in devices) / len(devices)

    def pageable_s(self, devices) -> float:
        """Seconds of copies through pageable memory, averaged over
        ``devices``."""
        return sum(self.pageable_by_device.get(d, 0.0) for d in devices) / len(devices)


def profiler():
    """A profiler of the host and the cards, with nothing recorded beyond
    the events' names and times."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def span(name: str, on: bool):
    """A ``record_function`` range where tracing is on, else nothing."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def events(prof) -> list:
    """The profile's chrome-trace events (written to a temporary file under
    ``TMPDIR`` and removed once read)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def _union(intervals: list) -> list:
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def summarize(evts: list, devices) -> TraceSummary:
    """Read the window (the ``window`` span; µs in the trace, seconds out),
    the busy and the pageable-copy time of each of ``devices`` (card
    indices), the device operations and the idle time by host span from
    chrome-trace events. No ``window`` span: an empty summary."""
    spans: dict = {}
    dev: list = []
    for e in evts:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        lo, hi = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat", "")
        if cat == "user_annotation" and e.get("name") in SPANS + ("window",):
            spans.setdefault(e["name"], []).append((lo, hi))
        elif cat in DEVICE_CATS:
            d = (e.get("args") or {}).get("device")
            dev.append((e.get("name", ""), -1 if d is None else int(d), lo, hi))
    if "window" not in spans:
        return TraceSummary(0.0, {}, [])
    w0, w1 = min(s[0] for s in spans["window"]), max(s[1] for s in spans["window"])
    calls = sorted((lo, hi, name) for name in SPANS for lo, hi in spans.get(name, ()))
    starts = [c[0] for c in calls]
    ops, per_dev, paged = [], {}, {}
    for name, d, lo, hi in dev:
        lo, hi = max(lo, w0), min(hi, w1)
        if hi > lo:
            ops.append((name, d, (hi - lo) * 1e-6))
            (paged if PAGEABLE in name else per_dev).setdefault(d, []).append((lo, hi))
    busy, idle, pageable = {}, {}, {}
    for d in devices:
        pageable[d] = sum(hi - lo for lo, hi in _union(paged.get(d, []))) * 1e-6
        merged = _union(per_dev.get(d, []))
        busy[d] = sum(hi - lo for lo, hi in merged) * 1e-6
        edges = [w0] + [x for lo, hi in merged for x in (lo, hi)] + [w1]
        for lo, hi in zip(edges[::2], edges[1::2]):
            if hi > lo:
                _idle(lo, hi, calls, starts, idle)
    return TraceSummary((w1 - w0) * 1e-6, busy, ops, idle, pageable)


def _idle(lo: float, hi: float, spans: list, starts: list, idle: dict) -> None:
    """Add the idle gap ``[lo, hi)`` to the benchmark span open over each
    part of it (``spans`` sorted and disjoint, ``starts`` their starts),
    the rest to "between calls"."""
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    covered = 0.0
    while i < len(spans) and spans[i][0] < hi:
        a, b, name = max(spans[i][0], lo), min(spans[i][1], hi), spans[i][2]
        if b > a:
            idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
            covered += b - a
        i += 1
    idle["between calls"] = idle.get("between calls", 0.0) + (hi - lo - covered) * 1e-6
