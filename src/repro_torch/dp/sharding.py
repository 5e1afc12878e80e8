"""Sharded bucket drains: split a batched solve over a mesh of slots.

A bucket drain is embarrassingly parallel across instances — every lane of
a batched solve is independent — so the batch axis is the natural
partition axis: each slot solves its shard of the bucket with the same
route (one kernel launch a slot on a kernel route), and the results
concatenate back bit-identical to the unsharded solve.

A slot (``repro_torch.runtime.sharding.Slot``) is a device and, on a card,
a CUDA stream of its own. On a host with k cards :func:`default_mesh` has
one slot per card; a mesh may also list one card several times, and its
slots' launches then run on concurrent streams of that card (the same mesh
over ``cpu`` slots runs the shards one after the other).

The engine runs in one process over every slot of its mesh, or as a
per-rank program (the reference's ``shard_map``): ``ShardedDPEngine(comm=
comm)`` in every rank of ``runtime.sharding.run`` or
``runtime.distributed.launch``, each rank submitting the same instances,
solving its own share of each bucket and gathering the shares from its
peers.

Mechanics:

  * :class:`ShardContext` carries the mesh (and, per rank, the ``Comm``)
    plus the hooks the batch runners in ``repro_torch.dp.backends``
    consume: ``stack`` (cast and stack the bucket's inputs on the host and
    copy each slot's contiguous share to its device, on its stream; a rank
    casts and copies its own share only), ``wrap`` (run the route's batch
    call once a slot this process runs, on its device and stream, then
    gather the shares in slot order: on the first slot's device after
    joining every slot's stream, or on every rank by ``comm.all_gather``)
    and ``regime``.
  * Ragged buckets pad up to a multiple of the mesh size by replicating
    the last spec; the pad lanes are sliced off the tables, args and paths
    before fan-out and counted in ``stats["padded_lanes"]``.
  * :class:`ShardedDPEngine` routes each drain through the normal
    ``routing``/``autotune`` stack, but ranks batchable routes on — and
    feeds realized drain latencies back under — the distinct
    ``("shard", ndev)`` measurement regime, so multi-slot amortization
    never pollutes single-slot calibration entries. Loop-only routes (no
    ``batch_run``) run unsharded under their own regimes (on every rank);
    a one-slot mesh falls back to plain drains. Ranks feed back the
    slowest rank's drain time, so their calibration tables, and with them
    their routes, stay equal.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.dp import backends as _backends
from repro_torch.dp import reconstruct as _reconstruct
from repro_torch.dp import routing as _routing
from repro_torch.dp import telemetry as _telemetry
from repro_torch.dp.engine import DPEngine
from repro_torch.runtime import sharding as _rt
from repro_torch.runtime.sharding import Comm, Mesh

#: mesh axis name of the bucket's batch dimension
BATCH_AXIS = "shard"


def device_count() -> int:
    """Visible CUDA cards (0 without one)."""
    return torch.cuda.device_count()


def default_mesh(axis: str = BATCH_AXIS, devices=None) -> Mesh:
    """1-D mesh with one slot per device: ``devices``, or every visible
    card (the serving tier shards buckets, not tables, so one axis is the
    whole story)."""
    if devices is None:
        if not device_count():
            raise RuntimeError("repro_torch: no CUDA device is available; pass "
                               "the mesh's devices (e.g. ['cpu'] * 4)")
        devices = [torch.device("cuda", i) for i in range(device_count())]
    return Mesh(list(devices), (axis,))


def _gather(outs: list, slots: list, home: torch.device):
    """The slots' outputs (equal structures of tuples of tensors)
    concatenated along the batch in slot order on ``home``, each slot's
    stream joined first."""
    first = outs[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_gather([o[i] for o in outs], slots, home)
                           for i in range(len(first)))
    return torch.cat([_rt.join(t, s).to(home) for t, s in zip(outs, slots)], dim=0)


@dataclasses.dataclass(frozen=True)
class ShardContext:
    """Everything a batch runner needs to run one bucket drain sharded over
    ``mesh`` along ``axis``: over every slot in this process, or, given
    ``comm`` (a rank's ``runtime.sharding.Comm`` over ``mesh``), over this
    rank's slot alone. Frozen — one context per engine."""

    mesh: Mesh
    axis: str = BATCH_AXIS
    comm: Optional[Comm] = None

    def __post_init__(self):
        if self.axis not in self.mesh.axis_names:
            raise ValueError(f"axis {self.axis!r} not in mesh axes "
                             f"{self.mesh.axis_names}")

    @functools.cached_property
    def line(self) -> Mesh:
        """The slots along :attr:`axis` (the others at index 0)."""
        return self.mesh.line(self.axis)

    @property
    def ndev(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def slots(self) -> list:
        """The slots whose shares this process solves: every slot of
        :attr:`line`, or the rank's own."""
        return [self.comm.slot] if self.comm is not None else list(self.line.slots)

    @property
    def home(self) -> torch.device:
        """Where gathered results land: the first slot's device, or the
        rank's."""
        return self.slots[0].device

    def regime(self, reconstruct: bool = False) -> tuple:
        """Calibration-key suffix of a drain run under this context — the
        ``("shard", ndev)`` measurement regime (``backends.
        is_regime_marker``), with the arg-emitting variant marked so
        sharded reconstruct drains stay separate too."""
        marker = ("shard", self.ndev)
        if reconstruct:
            marker += ("reconstruct",)
        return (marker,)

    def pad(self, specs: list) -> tuple:
        """Pad a ragged bucket to a multiple of the mesh size by
        replicating the last spec (a real instance, so every lane runs the
        ordinary solve). Returns ``(padded_specs, n_pad)``; callers slice
        the pad lanes away."""
        b = len(specs)
        target = -(-b // self.ndev) * self.ndev
        return list(specs) + [specs[-1]] * (target - b), target - b

    def place(self, arr) -> list:
        """A host-stacked bucket (numpy, batch first) as one tensor a slot of
        :attr:`line`: each slot's contiguous slice of the batch, copied to
        its device on its stream."""
        return list(_rt.place(arr, self.line, (self.axis,)))

    def stack(self, arrays: list) -> list:
        """The bucket's per-instance arrays, cast to float32 and stacked on
        the host (``backends.host_stack``), as one tensor a slot of
        :attr:`slots` (:meth:`place`); a rank casts, stacks and copies its
        own share alone (``tensor_split``'s)."""
        if self.comm is None:
            return self.place(_backends.host_stack(arrays))
        k, n = self.comm.share(self.axis)
        mine = np.array_split(np.arange(len(arrays)), n)[k]
        host = _backends.host_stack([arrays[i] for i in mine])
        return [_rt.copy_to(torch.from_numpy(host), self.comm.slot)]

    def wrap(self, call):
        """``call`` run once a slot of :attr:`slots` over placed inputs (each
        a per-slot list from :meth:`stack`, or None), on the slot's device
        and stream; the outputs (a tensor or nested tuples of them)
        concatenated along the batch in slot order on :attr:`home`: every
        slot's stream joined first, or, per rank, gathered from every rank
        of the axis in one ``all_gather``. A slot's failure raises out of
        the call."""
        def run(*placed):
            outs = []
            for k, slot in enumerate(self.slots):
                with slot.scope():
                    outs.append(call(*(None if p is None else p[k] for p in placed)))
            if self.comm is None:
                return _gather(outs, self.slots, self.home)
            got = self.comm.all_gather(tuple(_rt.tensors(outs[0])), self.axis, 0)
            return _rt.refill(outs[0], iter(got))
        return run


class ShardedDPEngine(DPEngine):
    """DPEngine whose bucket drains run sharded over a mesh of slots.

    Batchable routes pad the bucket to the mesh size and run through the
    batch runners' sharded path; loop-only routes (and one-slot meshes)
    fall back to the plain drain. Observations and route ranking use the
    ``("shard", ndev)`` regime for sharded drains and the ordinary
    single-device regimes for unsharded ones. The engine's device is the
    mesh's first slot's.

    Given ``comm`` (a rank's ``Comm``: ``runtime.sharding.run``'s, or
    ``runtime.distributed.launch``'s ``ProcessComm``), the engine is one
    rank of a per-rank program over ``comm.mesh``: every rank submits the
    same requests and steps alike, solves its share of each sharded drain
    on its own slot (its device the engine's) and gathers the others'
    (:class:`ShardContext`), and feeds back the slowest rank's drain time,
    so every rank's calibration table, and so its routing, stays the
    same."""

    def __init__(self, mesh: Optional[Mesh] = None, axis: Optional[str] = None,
                 comm: Optional[Comm] = None, **kw):
        if comm is not None:
            mesh = comm.mesh
        elif mesh is None:
            mesh = default_mesh(axis or BATCH_AXIS)
        ctx = ShardContext(mesh=mesh, axis=axis or mesh.axis_names[0], comm=comm)
        kw.setdefault("device", ctx.home)
        super().__init__(**kw)
        self.ctx = ctx
        self.stats.update({"sharded_drains": 0, "padded_lanes": 0})

    # -- regime / shardability hooks (DPEngine drain internals) -----------
    def _will_shard(self, backend, spec0, reconstruct: bool) -> bool:
        if self.ctx.ndev <= 1:
            return False
        if reconstruct:
            return (backend.batch_run_with_args is not None
                    and _reconstruct.supports_args(spec0))
        return backend.batch_run is not None

    def _batch_regime(self, reconstruct: bool) -> tuple:
        if self.ctx.ndev <= 1:
            return super()._batch_regime(reconstruct)
        return self.ctx.regime(reconstruct)

    def _loop_regime(self, reconstruct: bool) -> tuple:
        return super()._batch_regime(reconstruct)

    def _obs_suffix(self, backend, spec0, reconstruct: bool) -> tuple:
        """The regime this drain will actually run under: sharded for
        batchable routes, the single-device regime for loop-only ones."""
        if self._will_shard(backend, spec0, reconstruct):
            return self.ctx.regime(reconstruct)
        return self._loop_regime(reconstruct)

    def _sync(self) -> None:
        """Wait for every card this process runs slots on, so a drain's
        clock brackets its own work on all of them."""
        for dev in {s.device for s in self.ctx.slots if s.device.type == "cuda"}:
            torch.cuda.synchronize(dev)

    def _agreed_ms(self, ms: float) -> float:
        """Per rank, the largest of the ranks' ``ms`` for one drain (every
        rank measures the same drains, and observes this value)."""
        if self.ctx.comm is None:
            return ms
        return float(self.ctx.comm.all_max(torch.tensor(ms, dtype=torch.float64),
                                           self.ctx.axis))

    # -- one sharded drain --------------------------------------------------
    def _run_bucket(self, backend, specs, reconstruct: bool):
        if not self._will_shard(backend, specs[0], reconstruct):
            return super()._run_bucket(backend, specs, reconstruct)
        b = len(specs)
        padded, n_pad = self.ctx.pad(specs)
        if reconstruct:
            tables, argss, source, paths = _routing.run_batch_with_args(
                backend, padded, self.device, sharding=self.ctx)
            tables, argss = tables[:b], argss[:b]
            if paths is not None:
                paths = paths[:b]
        else:
            tables = _routing.run_batch(backend, padded, self.device,
                                        sharding=self.ctx)[:b]
            argss, source, paths = None, None, None
        self.stats["sharded_drains"] += 1
        self.stats["padded_lanes"] += n_pad
        rep = _telemetry.current_drain()
        if rep is not None:
            rep.sharded = True
        _telemetry.count("dp_engine_sharded_drains_total")
        _telemetry.count("dp_engine_padded_lanes_total", n_pad)
        return tables, argss, source, paths
