"""Op-level accounting for the dry run's roofline (the counterpart of
``repro/launch/hlo_analysis.py``).

The reference compiles one rank's SPMD-partitioned HLO and re-walks it:
dot FLOPs and HBM traffic at fusion boundaries, multiplied by loop trip
counts, and collective output bytes. PyTorch has no HLO. What one rank runs
is its eager op stream, and each op is a kernel boundary on the card, as a
fusion is in XLA; so this module runs the rank's step once (on ``meta``
tensors in the dry run: nothing is computed or allocated) under two modes
and reads what it ran:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over every op
    (matmuls, convolutions, attention), K7 and K7b by their registered
    formulas (``kernels/flash_attention.py``: the tiles the kernels
    compute);
  * HBM traffic: the operand and output bytes of every op, views and
    metadata ops (no bytes moved) left out, as ``_NO_TRAFFIC`` does;
  * peak memory: the most bytes live at once, each output keyed by its
    storage and freed when the last tensor on that storage dies (a
    ``weakref.finalize``), on top of the step's arguments;
  * collective bytes by kind, from the rank's communicator's log
    (``runtime/sharding.py``: ``Comm.log``, ``RecordingComm``).

Python loops run out in full, so nothing is multiplied and
``unknown_trip_counts`` is always 0. :func:`top_contributors` attributes
the same quantities by op.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.runtime.sharding import COLLECTIVES, tensors

#: aten ops that move no bytes of their own: allocations, metadata, aliases
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "alias", "lift_fresh", "sym_size", "sym_stride", "sym_numel",
               "sym_storage_offset", "_local_scalar_dense", "set_", "resize_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _moves_bytes(func) -> bool:
    return not (func.is_view or func._schema.name.split("::")[-1] in _NO_TRAFFIC)


class OpTrace(TorchDispatchMode):
    """Every aten op run under it: its name, operand and output bytes, and
    the live bytes of the storages its outputs made (the peak kept)."""

    def __init__(self):
        super().__init__()
        self.rows: list = []          # (op name, traffic bytes)
        self.live = self.peak = 0
        self._refs: dict = defaultdict(int)
        self._size: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _moves_bytes(func):
            moved = sum(_nbytes(t) for t in tensors((args, kwargs)))
            moved += sum(_nbytes(t) for t in tensors(out))
            self.rows.append((func._schema.name, moved))
        for t in tensors(out):
            self._hold(t)
        return out

    def pin(self, obj) -> None:
        """Hold the storages of ``obj``'s tensors (the step's arguments) for
        the whole trace, counted at 0: a view of one allocates nothing."""
        for t in tensors(obj):
            key = t.untyped_storage()._cdata
            self._size.setdefault(key, 0)
            self._refs[key] += 1
            t._op_trace_held = self

    def _hold(self, t: torch.Tensor) -> None:
        if getattr(t, "_op_trace_held", None) is self:
            return
        t._op_trace_held = self
        key = t.untyped_storage()._cdata
        if key not in self._size:
            self._size[key] = t.untyped_storage().nbytes()
            self.live += self._size[key]
            self.peak = max(self.peak, self.live)
        self._refs[key] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= self._size.pop(key)


def trace(fn, *args, **kwargs) -> tuple:
    """``fn(*args, **kwargs)`` run under an :class:`OpTrace` (its arguments
    pinned) and a ``FlopCounterMode``: (its result, the trace, the flop
    counter)."""
    flops = FlopCounterMode(display=False)
    ops = OpTrace()
    ops.pin((args, kwargs))
    with flops, ops:
        out = fn(*args, **kwargs)
    return out, ops, flops


def collectives(log: list) -> tuple:
    """({kind: bytes}, {kind: count}) of a communicator's log, every kind of
    ``COLLECTIVES`` present."""
    nbytes = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for kind, n in log:
        nbytes[kind] += n
        counts[kind] += 1
    return nbytes, counts


def analyze(ops: OpTrace, flops: FlopCounterMode, log: list) -> dict:
    """The reference's keys (``hlo_analysis.analyze``) of one traced rank:
    ``ops`` and ``flops`` from :func:`trace`, ``log`` its communicator's."""
    coll, counts = collectives(log)
    return {
        "flops": float(flops.get_total_flops()),
        "hbm_traffic_bytes": float(sum(n for _, n in ops.rows)),
        "collective_bytes": coll,
        "collective_bytes_total": sum(coll.values()),
        "collective_counts": counts,
        "unknown_trip_counts": 0,
        "n_ops": len(ops.rows),
        "peak_live_bytes": ops.peak,
    }


def top_contributors(ops: OpTrace, flops: FlopCounterMode, log: list, n: int = 15,
                     what: str = "collective") -> list:
    """The ``n`` largest contributors by op (by kind for collectives) to
    collective bytes ("collective"), HBM traffic ("traffic") or FLOPs
    ("flops"): rows of (value, count, name), largest first."""
    acc: dict = defaultdict(lambda: [0.0, 0])
    if what == "collective":
        for kind, b in log:
            acc[kind][0] += b
            acc[kind][1] += 1
    elif what == "traffic":
        for name, b in ops.rows:
            acc[name][0] += b
            acc[name][1] += 1
    elif what == "flops":
        for op, f in flops.get_flop_counts().get("Global", {}).items():
            acc[str(op)] = [float(f), 1]
    else:
        raise ValueError(f"unknown contributor kind {what!r}")
    rows = sorted(((v, c, name) for name, (v, c) in acc.items()), key=lambda r: -r[0])
    return rows[:n]
