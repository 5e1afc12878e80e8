"""One process a rank: the per-rank program of ``runtime/sharding.py`` with
its collectives over ``torch.distributed``, the port's counterpart of the
concurrent per-device programs XLA partitions the reference's sharded
programs into.

:class:`ProcessComm` is a :class:`~repro_torch.runtime.sharding.Comm` whose
collectives move bytes through process groups instead of meeting on a
board in one process. It gives the same bits and logs the same (kind,
bytes) as the threaded ``Comm``:

* ``all_reduce``: each member's tensors are split into n flat slices
  (``tensor_split``), slice k goes to member k (an all-to-all), each
  member adds the n slices it holds in group order from the first, and
  the sums are all-gathered. Every element is added in ``Comm._sum``'s
  order, so the bits are its bits, and the bytes moved are a ring
  all-reduce's. The backend's own reduction never runs: its order of
  addition is the backend's.
* ``reduce_scatter``: each member's chunk k goes to member k (an
  all-to-all, ``parts`` cut as ``Comm.reduce_scatter`` cuts them), summed
  in group order.
* ``all_gather``, ``all_max`` and ``exchange``: every tensor of the payload
  all-gathered (every member's of the same shape, as
  :class:`~repro_torch.runtime.sharding.RecordingComm` takes them to be),
  then ``Comm``'s own code on the members' tensors.
* ``all_to_all``: the chunks' shapes first (a small int64 all-gather: the
  spans of a prompt's cache write may be ragged), then the chunks.
* ``permute``: point to point (``batch_isend_irecv``): the tensors' shapes
  to the member the payload goes to, then the payload (a pipeline's idle
  stage sends a microbatch of no rows).

Every backend call moves one flat uint8 buffer, each tensor's bytes at a
multiple of 16, so every dtype crosses every backend and a collective of a
tuple is one call.

:func:`launch` runs ``fn(comm)`` in one process a rank (the ``spawn``
start method: CUDA cannot fork). The backend is fixed by a pure rule on
the ranks' devices before any process starts (:func:`backend_for`): NCCL
where every rank has a card of its own, gloo otherwise (CPU ranks, or
several ranks on one card, which NCCL refuses). Gloo's ``all_gather`` and
``all_to_all_single`` take CPU tensors only, so a rank on a card under
gloo stages every collective through pinned host memory
(:func:`stages`). No rule is tried and dropped: a failure raises.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import multiprocessing
import multiprocessing.connection
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import Comm, Mesh, Slot, refill, tensors

#: the byte alignment of each tensor in a packed buffer (a view as any dtype)
ALIGN = 16
#: seconds the launcher waits, once a rank has failed, for the others to end
#: on their own (their collectives fail) before it ends them
GRACE_S = 10.0
#: the top-level packages no rank may load (the port stands alone)
FOREIGN = ("jax", "jaxlib", "repro")


# ---------------------------------------------------------------------------
# The backend rule
# ---------------------------------------------------------------------------
def backend_for(devices: Sequence) -> str:
    """``"nccl"`` where every rank has a CUDA card of its own, else
    ``"gloo"`` (CPU ranks, or several ranks on one card: NCCL refuses two
    ranks on a device)."""
    devs = [torch.device(d) for d in devices]
    cards = [d.index for d in devs if d.type == "cuda"]
    if len(cards) == len(devs) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def stages(backend: str, device) -> bool:
    """Whether a rank on ``device`` copies every collective's bytes through
    pinned host memory: a card under gloo, whose ``all_gather`` and
    ``all_to_all_single`` take CPU tensors only."""
    return backend == "gloo" and torch.device(device).type == "cuda"


# ---------------------------------------------------------------------------
# Packed buffers
# ---------------------------------------------------------------------------
def _pack(ts: Sequence[torch.Tensor], device, size: Optional[int] = None) -> tuple:
    """(one uint8 buffer on ``device`` holding ``ts``' bytes, each at a
    multiple of :data:`ALIGN`, zero-padded to ``size`` bytes where given;
    each tensor's (shape, dtype, offset, bytes))."""
    metas, pieces, off = [], [], 0
    for t in ts:   # a tensor elsewhere (a host scalar under NCCL) is moved to ``device``
        b = t.detach().contiguous().reshape(-1).view(torch.uint8).to(device)
        n = b.numel()
        metas.append((tuple(t.shape), t.dtype, off, n))
        pieces.append(b)
        pad = -n % ALIGN
        if pad:
            pieces.append(b.new_zeros(pad))
        off += n + pad
    if size is not None and size > off:
        pieces.append(torch.zeros(size - off, dtype=torch.uint8, device=device))
    buf = (torch.cat(pieces) if pieces
           else torch.empty(0, dtype=torch.uint8, device=device))
    return buf, metas


def _packed_size(metas: list) -> int:
    return sum(n + (-n % ALIGN) for *_, n in metas)


def _unpack(buf: torch.Tensor, metas: list) -> list:
    """The tensors :func:`_pack` put in ``buf`` (views of it)."""
    return [buf[off:off + n].view(dtype).reshape(shape) for shape, dtype, off, n in metas]


def _summed(parts: list) -> list:
    """Tensor i of every member's list in ``parts`` added in group order
    from the first, as ``Comm._sum`` adds."""
    out = []
    for i in range(len(parts[0])):
        total = parts[0][i]
        for p in parts[1:]:
            total = total + p[i]
        out.append(total)
    return out


# ---------------------------------------------------------------------------
# The communicator
# ---------------------------------------------------------------------------
class CollectiveError(RuntimeError):
    """A backend collective failed in this rank (a peer ended, or the
    collective timed out): the consequence of another rank's failure, not
    its cause."""


#: this process's process groups by their set of world ranks (a group of
#: two meshes over the same ranks is made once)
_GROUPS: dict = {}


def _partition(shape: tuple, axis_names: tuple, axes: tuple) -> list:
    """The groups of world ranks (row-major over ``shape``) that share every
    coordinate but ``axes``, each sorted, in order of their first rank."""
    groups: dict = {}
    for r, idx in enumerate(np.ndindex(shape)):
        key = tuple(i for i, a in zip(idx, axis_names) if a not in axes)
        groups.setdefault(key, []).append(r)
    return list(groups.values())


def rank_mesh(shape: Sequence[int], axis_names: Sequence[str], devices: Sequence,
              rank: int) -> Mesh:
    """The mesh as rank ``rank`` sees it: its own slot (its device and, on a
    card, a stream of its own) and every other rank's device alone, so the
    rank makes no stream, and opens no context, on another card."""
    slots = np.empty(len(devices), dtype=object)
    for r, d in enumerate(devices):
        dev = torch.device(d)
        own = r == rank and dev.type == "cuda"
        slots[r] = Slot(dev, torch.cuda.Stream(dev) if own else None)
    return Mesh.of_slots(slots.reshape(tuple(shape)), tuple(axis_names))


class ProcessComm(Comm):
    """One rank's :class:`Comm` in a process of its own: the same
    coordinates, groups, ``share``, ``log`` and ``tape``, the collectives
    over ``torch.distributed`` (module docstring). Made in every rank of a
    :func:`launch` in the same order (it makes the process groups of every
    set of the mesh's axes, and ``new_group`` is itself collective)."""

    def __init__(self, mesh: Mesh, index: tuple, devices: Sequence, stage: bool):
        super().__init__(mesh, index, None)
        self.devices, self.stage = [torch.device(d) for d in devices], stage
        names = mesh.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                for ranks in _partition(mesh.slots.shape, names, axes):
                    key = frozenset(ranks)
                    if len(ranks) > 1 and key not in _GROUPS:
                        _GROUPS[key] = (dist.group.WORLD if len(ranks) == dist.get_world_size()
                                        else dist.new_group(ranks))

    def remesh(self, shape: Sequence[int], axis_names: Sequence[str]) -> "ProcessComm":
        """This rank's communicator over the same processes arranged as
        another mesh (every rank calls it, in the same order); the slot,
        its stream included, is this one's."""
        slots = np.empty(len(self.devices), dtype=object)
        for r, d in enumerate(self.devices):
            slots[r] = self.slot if r == self.rank else Slot(d, None)
        mesh = Mesh.of_slots(slots.reshape(tuple(shape)), tuple(axis_names))
        return ProcessComm(mesh, np.unravel_index(self.rank, tuple(shape)), self.devices,
                           self.stage)

    # -- moving bytes ---------------------------------------------------------
    def _pg(self, group: list) -> tuple:
        """(the process group of ``group``'s ranks, each member's rank in
        it, in group order: a process group orders its ranks by world
        rank)."""
        order = sorted(group)
        return _GROUPS[frozenset(group)], [order.index(r) for r in group]

    def _empty(self, nbytes: int) -> torch.Tensor:
        if self.stage:
            return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return torch.empty(nbytes, dtype=torch.uint8, device=self.device)

    def _out(self, buf: torch.Tensor) -> torch.Tensor:
        """``buf`` where the backend reads it: in pinned host memory, after
        this slot's stream has made it, where the rank stages."""
        if not self.stage:
            return buf
        host = self._empty(buf.numel())
        host.copy_(buf, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return host

    def _in(self, buf: torch.Tensor) -> torch.Tensor:
        return buf.to(self.device, non_blocking=True) if self.stage else buf

    @staticmethod
    def _call(op, *args, **kw) -> None:
        try:
            op(*args, **kw)
        except Exception as e:   # re-raised as what it is: a peer's failure seen here
            raise CollectiveError(f"{op.__name__} failed in this rank: {e}") from e

    def _gather_bytes(self, buf: torch.Tensor, group: list) -> list:
        """Every member's ``buf`` (one size on every member), in group
        order."""
        pg, pos = self._pg(group)
        src = self._out(buf)
        got = [self._empty(src.numel()) for _ in group]
        self._call(dist.all_gather, got, src, group=pg)
        return [self._in(got[p]) for p in pos]

    def _to_all_bytes(self, bufs: list, sizes: list, group: list) -> list:
        """``bufs[k]`` to the group's k-th member; returns what each member
        sent this one (``sizes[k]`` bytes from the k-th), in group order."""
        pg, pos = self._pg(group)
        member = {p: k for k, p in enumerate(pos)}   # process-group rank -> group position
        send = [bufs[member[p]] for p in range(len(group))]
        recv = [sizes[member[p]] for p in range(len(group))]
        out = self._empty(sum(recv))
        self._call(dist.all_to_all_single, out, self._out(torch.cat(send)), recv,
                   [b.numel() for b in send], group=pg)
        pieces = torch.split(self._in(out), recv)
        return [pieces[p] for p in pos]

    def _sendrecv(self, buf: torch.Tensor, nbytes: int, dst: int, src: int,
                  group: list) -> torch.Tensor:
        """``buf`` to world rank ``dst``, and ``nbytes`` bytes from world rank
        ``src``, in one batch of point-to-point calls (each at least
        :data:`ALIGN` bytes: ``buf`` zero-padded, the padding dropped)."""
        pg, _ = self._pg(group)
        if buf.numel() < ALIGN:
            buf = _pack([buf], self.device, ALIGN)[0]
        out = self._empty(max(nbytes, ALIGN))
        ops = [dist.P2POp(dist.isend, self._out(buf), dst, pg),
               dist.P2POp(dist.irecv, out, src, pg)]

        def swap():
            for work in dist.batch_isend_irecv(ops):
                work.wait()

        self._call(swap)
        return self._in(out)[:nbytes]

    # -- the collectives --------------------------------------------------------
    def _permute(self, xs: tuple, axes, shift: int) -> tuple:
        group = self.group(axes)
        me, n = group.index(self.rank), len(group)
        dst, src = group[(me + shift) % n], group[(me - shift) % n]
        dims = torch.tensor([d for x in xs for d in x.shape], dtype=torch.int64)
        got = self._sendrecv(dims.view(torch.uint8).to(self.device), dims.numel() * 8, dst, src,
                             group).view(torch.int64).tolist()
        metas, off = [], 0
        for x in xs:
            shape, got = tuple(got[:x.dim()]), got[x.dim():]
            nbytes = int(np.prod(shape)) * x.element_size()
            metas.append((shape, x.dtype, off, nbytes))
            off += nbytes + (-nbytes % ALIGN)
        buf, _ = _pack(list(xs), self.device)
        return tuple(_unpack(self._sendrecv(buf, off, dst, src, group), metas))

    def _exchange(self, payload, axes) -> list:
        group = self.group(axes)
        if len(group) == 1:
            return [payload]
        buf, metas = _pack(list(tensors(payload)), self.device)
        got = self._gather_bytes(buf, group)
        return [payload if r == self.rank else refill(payload, iter(_unpack(b, metas)))
                for r, b in zip(group, got)]

    def _sum(self, xs: tuple, axes) -> tuple:
        group = self.group(axes)
        n, me = len(group), group.index(self.rank)
        flat = [x.detach().reshape(-1) for x in xs]
        sends = [_pack([torch.tensor_split(f, n)[k] for f in flat], self.device) for k in range(n)]
        mine = sends[me][1]
        got = self._to_all_bytes([b for b, _ in sends], [_packed_size(mine)] * n, group)
        sums = _summed([_unpack(b, mine) for b in got])
        width = _packed_size(sends[0][1])   # slice 0 is the longest of each tensor
        buf, _ = _pack(sums, self.device, width)
        whole = [_unpack(b, sends[k][1]) for k, b in enumerate(self._gather_bytes(buf, group))]
        out = []
        for i, x in enumerate(xs):
            res = torch.empty_like(x, requires_grad=False)
            res.copy_(torch.cat([w[i] for w in whole]).view(x.shape))
            out.append(res)
        out = tuple(out)
        self._record("all-reduce", out)
        return out

    def reduce_scatter(self, xs: tuple, axes, dims: tuple, parts: int = 1) -> tuple:
        group = self.group(axes)
        n = len(group)
        if n == 1:
            return super().reduce_scatter(xs, axes, dims, parts)
        me = group.index(self.rank)

        def chunk(t, d, k):
            return torch.cat([torch.chunk(c, n, dim=d)[k] for c in torch.chunk(t, parts, dim=d)],
                             dim=d)

        xs = tuple(x.detach() for x in xs)
        sends = [_pack([chunk(x, d, k) for x, d in zip(xs, dims)], self.device)
                 for k in range(n)]
        mine = sends[me][1]
        got = self._to_all_bytes([b for b, _ in sends], [_packed_size(mine)] * n, group)
        out = tuple(_summed([_unpack(b, mine) for b in got]))
        self._record("reduce-scatter", out)
        return out

    def _to_all(self, chunks: tuple, axes) -> tuple:
        group = self.group(axes)
        me = group.index(self.rank)
        chunks = tuple(c.detach() for c in chunks)
        shapes = torch.tensor([list(c.shape) for c in chunks], dtype=torch.int64)
        buf, metas = _pack([shapes.to(self.device)], self.device)
        theirs = [_unpack(b, metas)[0] for b in self._gather_bytes(buf, group)]
        dtype = chunks[0].dtype
        want = [[(tuple(int(s) for s in t[me].tolist()), dtype, 0,
                  int(np.prod(t[me].tolist())) * chunks[0].element_size())] for t in theirs]
        sends = [_pack([c], self.device)[0] for c in chunks]
        got = self._to_all_bytes(sends, [_packed_size(w) for w in want], group)
        out = tuple(_unpack(b, w)[0] for b, w in zip(got, want))
        self._record("all-to-all", out)
        return out


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RankReport:
    """What one rank's process hands back."""
    result: object        # fn's return value, its tensors on the CPU
    foreign: list         # modules of jax or repro loaded in the rank (none: it stands alone)
    contexts: list        # the cards on which the rank's process holds a context


@dataclasses.dataclass
class Launched:
    """A :func:`launch`'s reports, one a rank in rank order."""
    reports: list
    backend: str

    @property
    def result(self):
        """Rank 0's result."""
        return self.reports[0].result

    @property
    def results(self) -> list:
        return [r.result for r in self.reports]


@dataclasses.dataclass
class _Job:
    fn: object
    args: tuple
    shape: tuple
    axis_names: tuple
    devices: list
    backend: str
    init_method: str
    timeout: float
    threads: int
    numerics: dict


def _numerics() -> dict:
    """The caller's settings that change a kernel's bits, which each rank
    takes on."""
    return {"float32_matmul_precision": torch.get_float32_matmul_precision(),
            "cuda_matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "bf16_reduced": torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            "fp16_reduced": torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction,
            "deterministic": torch.are_deterministic_algorithms_enabled()}


def _take_numerics(n: dict) -> None:
    torch.set_float32_matmul_precision(n["float32_matmul_precision"])
    torch.backends.cuda.matmul.allow_tf32 = n["cuda_matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = n["cudnn_tf32"]
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = n["bf16_reduced"]
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = n["fp16_reduced"]
    if torch.are_deterministic_algorithms_enabled() != n["deterministic"]:   # seconds to set
        torch.use_deterministic_algorithms(n["deterministic"])


def _to_host(obj):
    """``obj`` with each tensor copied to memory of its own on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def launch_counts() -> dict:
    """``{kernel module: its LAUNCHES}`` of the kernel modules this process
    has loaded."""
    return {name: dict(mod.LAUNCHES) for name, mod in list(sys.modules.items())
            if name.startswith("repro_torch.kernels.") and hasattr(mod, "LAUNCHES")}


def _rank_run(rank: int, job: _Job) -> RankReport:
    dev = torch.device(job.devices[rank])
    torch.set_num_threads(1 if dev.type == "cpu" else job.threads)
    _take_numerics(job.numerics)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(job.backend, init_method=job.init_method, rank=rank,
                            world_size=len(job.devices),
                            timeout=datetime.timedelta(seconds=job.timeout),
                            **({"device_id": dev} if job.backend == "nccl" else {}))
    mesh = rank_mesh(job.shape, job.axis_names, job.devices, rank)
    comm = ProcessComm(mesh, np.unravel_index(rank, job.shape), job.devices,
                       stages(job.backend, dev))
    with sharding.acting_as(comm), comm.slot.scope():
        result = job.fn(comm, *job.args)
    report = RankReport(
        result=_to_host(result),
        foreign=sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN),
        contexts=[i for i in range(torch.cuda.device_count())
                  if torch._C._cuda_hasPrimaryContext(i)] if dev.type == "cuda" else [])
    dist.destroy_process_group()
    return report


def _report_path(job_dir: str, rank: int) -> str:
    return os.path.join(job_dir, f"rank{rank}.pt")


def _rank_main(rank: int, job_dir: str) -> None:
    """A rank's process: run the job, leave its report (or its error) in
    ``job_dir`` and end at once, with no destructors (a failed rank's peer
    may still hold one of its collectives open)."""
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    try:
        status = ("ok", _rank_run(rank, job))
    except BaseException as e:   # every failure is reported to the launcher, which raises it
        try:
            pickle.dumps(e)
            err = e
        except Exception:   # an exception that cannot cross processes travels as its text
            err = RuntimeError(f"{type(e).__name__}: {e}")
        status = ("error", err, traceback.format_exc(), isinstance(e, CollectiveError))
    tmp = _report_path(job_dir, rank) + ".tmp"
    torch.save(status, tmp)
    os.replace(tmp, _report_path(job_dir, rank))
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0 if status[0] == "ok" else 1)


def _await(procs: list) -> None:
    """Wait for every rank to end; once one has failed, give the others
    :data:`GRACE_S` to end on their own, then end them."""
    failed_at = None
    while True:
        alive = [p for p in procs if p.exitcode is None]
        if not alive:
            return
        if failed_at is None and any(p.exitcode not in (None, 0) for p in procs):
            failed_at = time.monotonic()
        if failed_at is not None and time.monotonic() - failed_at > GRACE_S:
            _end(alive)
            return
        multiprocessing.connection.wait([p.sentinel for p in alive], timeout=0.1)


def _end(procs: list) -> None:
    for p in procs:
        if p.exitcode is None:
            p.terminate()
    for p in procs:
        p.join(5.0)
        if p.exitcode is None:
            p.kill()
            p.join()


def launch(fn, mesh_shape: Sequence[int], axis_names: Sequence[str], devices: Sequence, *,
           args: tuple = (), init_method: Optional[str] = None,
           timeout: Optional[float] = None) -> Launched:
    """``fn(comm, *args)`` in one process a rank of a ``mesh_shape`` mesh
    (world rank r at the row-major index r), each with its own
    :class:`ProcessComm` and slot (its device, and a stream of its own on a
    card) current, as :func:`~repro_torch.runtime.sharding.run` runs it in
    a thread a slot.

    ``devices`` holds each rank's device; the backend is :func:`backend_for`
    them. ``fn`` and ``args`` are pickled: ``fn`` must
    live in an importable module (a rank imports it, and nothing of the
    caller's), and ``args`` should hold numpy arrays or CPU tensors.
    ``init_method`` is the rendezvous (default a ``file://`` one in a
    directory of its own); ``timeout`` bounds every collective (default
    ``sharding.COLLECTIVE_TIMEOUT_S``). Each rank runs with the caller's
    matmul settings, so its cuBLAS work rounds as the caller's does; a
    rank on the CPU runs one intra-op thread (the ranks share the host's
    cores, and pools of several threads a rank spin against each other).
    The kernels are built here first where a rank is on a card, so no
    rank runs ``nvcc``.

    Returns the ranks' :class:`RankReport`\\ s. A rank that raises ends the
    call: the others are given :data:`GRACE_S`, then ended, and the first
    exception in rank order is raised (one raised by a backend collective,
    a peer's failure seen in that rank, only where no rank raised
    another). No process outlives the call."""
    shape = tuple(int(s) for s in mesh_shape)
    n = int(np.prod(shape))
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) != n:
        raise ValueError(f"a {shape} mesh needs {n} devices, {len(devices)} given")
    backend = backend_for(devices)
    if any(torch.device(d).type == "cuda" for d in devices):
        from repro_torch.kernels import _build
        _build.build_all()
    job_dir = tempfile.mkdtemp(prefix="ranks-")
    procs: list = []
    try:
        job = _Job(fn, tuple(args), shape, tuple(axis_names), devices, backend,
                   init_method or f"file://{os.path.join(job_dir, 'rendezvous')}",
                   float(sharding.COLLECTIVE_TIMEOUT_S if timeout is None else timeout),
                   torch.get_num_threads(), _numerics())
        torch.save(job, os.path.join(job_dir, "job.pt"))
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(r, job_dir), name=f"rank{r}",
                             daemon=True) for r in range(n)]
        for p in procs:
            p.start()
        _await(procs)
        status = [torch.load(_report_path(job_dir, r), weights_only=False)
                  if os.path.exists(_report_path(job_dir, r)) else None for r in range(n)]
    finally:
        _end(procs)
        shutil.rmtree(job_dir, ignore_errors=True)
    errors = [(r, s) for r, s in enumerate(status) if s is not None and s[0] == "error"]
    real = [(r, s) for r, s in errors if not s[3]]
    if real:
        r, (_, err, tb, _) = real[0]
        err.add_note(f"raised in rank {r} of {n}; its traceback:\n{tb}")
        raise err
    if errors:
        r, (_, err, tb, _) = errors[0]
        raise RuntimeError(f"a collective failed in rank {r} of {n} and no rank raised "
                           f"anything else; its traceback:\n{tb}") from err
    lost = [(r, p.exitcode) for r, (p, s) in enumerate(zip(procs, status)) if s is None]
    if lost:
        raise RuntimeError(f"ranks ended with no report (rank, exit code): {lost}")
    return Launched([s[1] for s in status], backend)
