"""Rule-based sharding (port of ``repro/runtime/sharding.py``): logical
axis names -> mesh axes with the divisibility fallback, and the port's mesh
of card slots.

Every parameter / activation dimension carries a *logical* name ("embed",
"ffn", "experts", "kv_seq", …). A rule maps each name to a priority list of
mesh-axis candidates (strings, or tuples for compound axes). ``spec_for``
assigns, per tensor, the first candidate that (a) divides the dim size and
(b) has not been used by another dim of the same tensor — this is what lets
granite-moe's 40 experts fall back to sharding the expert FFN dim, and a
batch-1 cell shard its KV-cache sequence over *both* mesh axes. A spec is a
tuple with one entry per dim: a mesh axis name, a tuple of them, or None
(replicated).

The port's :class:`Mesh` is a mesh-shaped array of *slots*. A slot is a
``torch.device`` and, on a CUDA device, a ``torch.cuda.Stream`` of its own;
a mesh may list one card more than once, so several slots of one card run
their work on concurrent streams. :func:`place` puts a tensor over a mesh
(each sharded dim split by ``tensor_split``, the shards replicated across
the other axes) and :func:`gather` inverts it bit for bit.

The reference partitions one traced program with GSPMD under
``activate``; the port runs a *per-rank program* instead. :func:`run`
starts one Python thread per slot (a CUDA stream is current per thread, so
each thread makes its slot's stream current) and hands each a
:class:`Comm`: the slot's coordinates and the collectives ``all_reduce``,
``all_gather``, ``all_to_all`` and ``permute`` over named mesh axes. One slot runs at a
time and passes a turn on at each collective, so the slots of a collective
meet at a barrier (the turn's round) without contending for the
interpreter lock, while their launches overlap on their streams; they
combine in slot order, so a run gives the same bits every time. A slot
that raises breaks the barrier, and the call re-raises its exception once
every thread has ended. The layer functions take the communicator as an
argument; an unsharded model passes :data:`LOCAL`, whose collectives are
the identity, so both run one body. :func:`hint` is kept
as the point where the program re-places a tensor to ``spec_for``'s
placement of logical axes; outside :func:`activate` it returns the tensor
unchanged.

Training differentiates the per-rank program: a slot's :class:`Tape`
makes each collective a boundary of its graph and runs the collectives'
adjoints in the slot's own thread (its docstring says why), and a
:class:`RecordingComm` stands in for one rank alone, recording each
collective's kind and bytes instead of sending (the dry run,
``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------
def make_rules(multi_pod: bool = False) -> dict:
    fsdp = ("pod", "data") if multi_pod else "data"
    both = ("pod", "data", "model") if multi_pod else ("data", "model")
    return {
        # --- parameters ---
        "vocab": ["model"],
        "embed": [fsdp],
        "heads": ["model"],          # flattened n_heads*head_dim projections
        "kv": ["model"],             # flattened n_kv*head_dim projections
        "ffn": ["model"],
        "experts": ["model"],
        "expert_embed": [fsdp],
        "expert_ffn": ["model"],     # fallback target when experts don't divide
        "ssm_inner": ["model"],      # mamba/rwkv flattened head dims
        # --- activations / state ---
        "act_batch": [fsdp],
        "act_seq": [None],
        "act_seq_attn": ["model"],   # seq fallback when heads don't divide
        "kv_seq": [both, "model"],   # decode cache sequence axis
        "act_heads": ["model"],
        "act_embed": [None],
        "act_ffn": ["model"],
        "act_experts": ["model"],
        # the capacity dim takes the model axis only when the expert dim
        # could not (granite-moe's E = 40)
        "act_moe_cap": ["model"],
        "layers": [None],
        None: [None],
    }


def spec_for(shape: Sequence[int], axes: Sequence, rules: dict,
             axis_sizes: dict) -> tuple:
    """The spec of a tensor of ``shape`` whose dims carry logical ``axes``."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} differ in rank")
    used: set = set()
    out = []
    for dim, name in zip(shape, axes):
        choice = None
        for cand in rules.get(name, [None]):
            if cand is None:
                break
            parts = cand if isinstance(cand, tuple) else (cand,)
            if any(p in used for p in parts):
                continue
            size = int(np.prod([axis_sizes[p] for p in parts]))
            if dim % size == 0 and dim >= size:
                choice = cand
                used.update(parts)
                break
        out.append(choice)
    return tuple(out)


# ---------------------------------------------------------------------------
# The mesh of slots
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class Slot:
    """One place of a mesh: a device and, on a CUDA device, the stream its
    work runs on."""

    device: torch.device
    stream: Optional["torch.cuda.Stream"] = None

    @contextlib.contextmanager
    def scope(self):
        """Make this slot's device and stream current: tensors made and
        kernels launched inside run on them."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield

    def follow(self, t: torch.Tensor) -> None:
        """Order this slot's stream after the work that made ``t`` (on its
        device's current stream) and keep ``t``'s memory until this stream
        has read it."""
        if self.stream is not None and t.is_cuda:
            self.stream.wait_stream(torch.cuda.current_stream(t.device))
            t.record_stream(self.stream)


def join(t: torch.Tensor, slot: Slot) -> torch.Tensor:
    """``t``, made on ``slot``'s stream, made safe to read on its device's
    current stream: that stream waits for the slot's, and the caching
    allocator keeps ``t`` until it has read it."""
    if slot.stream is not None and t.is_cuda:
        cur = torch.cuda.current_stream(t.device)
        cur.wait_stream(slot.stream)
        t.record_stream(cur)
    return t


class Mesh:
    """A mesh-shaped array of :class:`Slot` with named axes.

    ``devices`` is a (nested) sequence or array of devices (or their
    names) in the mesh's shape; one device may appear more than once.
    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``'s
    does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} and axis names "
                             f"{axis_names} do not make a mesh")
        slots = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            dev = torch.device(arr[idx])
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            slots[idx] = Slot(dev, torch.cuda.Stream(dev) if dev.type == "cuda" else None)
        self._init(slots, axis_names)

    @classmethod
    def of_slots(cls, slots: np.ndarray, axis_names: Sequence[str]) -> "Mesh":
        """A mesh over existing slots (their streams shared)."""
        mesh = cls.__new__(cls)
        mesh._init(np.asarray(slots, dtype=object), tuple(axis_names))
        return mesh

    def _init(self, slots: np.ndarray, axis_names: tuple) -> None:
        self.slots = slots
        self.axis_names = axis_names
        self.devices = np.empty(slots.shape, dtype=object)
        for idx in np.ndindex(slots.shape):
            self.devices[idx] = slots[idx].device
        self.shape = dict(zip(axis_names, slots.shape))
        self.size = int(slots.size)

    def line(self, axis: str) -> "Mesh":
        """The 1-D mesh of the slots along ``axis`` (every other axis at
        index 0)."""
        k = self.axis_names.index(axis)
        idx = tuple(slice(None) if i == k else 0 for i in range(len(self.axis_names)))
        return Mesh.of_slots(self.slots[idx].reshape(-1), (axis,))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def _split_index(entry, coord: dict, sizes: dict) -> tuple:
    """(shard index, shard count) of the slot at ``coord`` along a spec
    entry (an axis name or a tuple of them, row-major)."""
    parts = entry if isinstance(entry, tuple) else (entry,)
    k, n = 0, 1
    for p in parts:
        k, n = k * sizes[p] + coord[p], n * sizes[p]
    return k, n


def _full_spec(spec: Sequence, ndim: int) -> tuple:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    return spec + (None,) * (ndim - len(spec))


def axes_of(entry) -> tuple:
    """A spec entry as a tuple of mesh axes (None: no axis)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def piece(t: torch.Tensor, spec: Sequence, coord: dict, sizes: dict,
          parts: Optional[Sequence] = None) -> torch.Tensor:
    """The shard of ``t`` that the slot at ``coord`` holds under ``spec``
    (a view of ``t``, or a concatenation where ``parts`` asks for one). A
    sharded dim is split by ``tensor_split``; where ``parts[dim]`` = P > 1
    the dim concatenates P equal parts (such as mamba's x | z columns) and
    the slot holds its ``tensor_split`` share of each part, concatenated:
    equally many columns, whole heads of every part where the heads
    divide."""
    spec = _full_spec(spec, t.ndim)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        k, n = _split_index(entry, coord, sizes)
        p = parts[dim] if parts else 1
        if p == 1:
            t = torch.tensor_split(t, n, dim=dim)[k]
        else:
            t = torch.cat([torch.tensor_split(c, n, dim=dim)[k]
                           for c in torch.chunk(t, p, dim=dim)], dim=dim)
    return t


def place(x, mesh: Mesh, spec: Sequence, parts: Optional[Sequence] = None) -> np.ndarray:
    """``x`` (a tensor or numpy array) over ``mesh``: a mesh-shaped object
    array holding each slot's shard (:func:`piece`) on the slot's device.
    Each dim whose spec entry names mesh axes is split into as many parts
    as those axes hold slots; the shards are replicated across the other
    axes. A copy to a card is issued on the slot's stream, so the slot's
    later work is ordered after it."""
    t = (torch.from_numpy(np.require(x, requirements="C"))
         if isinstance(x, (np.ndarray, np.generic)) else x)
    out = np.empty(mesh.slots.shape, dtype=object)
    for idx in np.ndindex(mesh.slots.shape):
        part = piece(t, spec, dict(zip(mesh.axis_names, idx)), mesh.shape, parts)
        out[idx] = copy_to(part, mesh.slots[idx])
    return out


def copy_to(t: torch.Tensor, slot: Slot) -> torch.Tensor:
    """A copy of ``t`` in memory of its own on ``slot``'s device, issued on
    the slot's stream after the work that made ``t``."""
    slot.follow(t)
    with slot.scope():
        return torch.empty(t.shape, dtype=t.dtype, device=slot.device).copy_(t)


def gather(placed: np.ndarray, mesh: Mesh, spec: Sequence,
           device=None, parts: Optional[Sequence] = None) -> torch.Tensor:
    """The tensor that :func:`place` split (with the same ``parts``), on
    ``device`` (default: the mesh's first slot's): shards concatenated
    along their dims in slot order, one replica of each taken from the
    slots at index 0 of the axes the spec does not name. Each shard's
    stream is joined first."""
    home = torch.device(device) if device is not None else mesh.slots.flat[0].device
    first = placed.flat[0]
    spec = _full_spec(spec, first.ndim)

    def build(dim: int, coord: dict) -> torch.Tensor:
        if dim == len(spec):
            idx = tuple(coord.get(a, 0) for a in mesh.axis_names)
            return join(placed[idx], mesh.slots[idx]).to(home)
        entry = spec[dim]
        if entry is None:
            return build(dim + 1, coord)
        axes = axes_of(entry)
        sizes = [mesh.shape[a] for a in axes]
        pieces = [build(dim + 1, {**coord, **dict(zip(axes, np.unravel_index(k, sizes)))})
                  for k in range(int(np.prod(sizes)))]
        p = parts[dim] if parts else 1
        if p > 1:   # each shard holds its share of every part, in part order
            split = [torch.chunk(t, p, dim=dim) for t in pieces]
            pieces = [s[i] for i in range(p) for s in split]
        return torch.cat(pieces, dim=dim)

    return build(0, {})


# ---------------------------------------------------------------------------
# The per-rank program: one thread a slot, collectives at a barrier (a turn
# passed round the slots)
# ---------------------------------------------------------------------------
#: seconds a slot waits at a collective for the others before the call fails
COLLECTIVE_TIMEOUT_S = 600.0


class _Rendezvous:
    """The meeting place of one :func:`run`: a turn that passes from slot to
    slot in rank order, and two boards where each slot leaves what it
    sends, used in turns.

    One slot runs at a time: it runs to its next collective, leaves its
    payload and passes the turn on; when the turn comes back every slot
    has reached the same collective, so the turn's round is the
    collective's barrier. Only the slot holding the turn runs Python, so
    the slots never contend for the interpreter lock; their launches still
    overlap on the card, each on its own stream. A slot that has passed a
    collective writes the next one's board, never the one the others may
    still read, so a board keeps its tensors alive until every slot has
    read them. :meth:`abort` wakes every slot and makes each wait raise
    ``threading.BrokenBarrierError``, as a wait past
    :data:`COLLECTIVE_TIMEOUT_S` does."""

    def __init__(self, n: int):
        self.n, self.timeout = n, COLLECTIVE_TIMEOUT_S
        self.boards = ([None] * n, [None] * n)
        self._turns = [threading.Lock() for _ in range(n)]   # held: not this slot's turn
        for turn in self._turns:
            turn.acquire()
        self._broken = False

    def take(self, rank: int) -> None:
        """Wait for this slot's turn."""
        if not self._broken and not self._turns[rank].acquire(timeout=self.timeout):
            self.abort()
        if self._broken:
            raise threading.BrokenBarrierError

    def give(self, rank: int) -> None:
        """Pass the turn to the next slot."""
        try:
            self._turns[(rank + 1) % self.n].release()
        except RuntimeError:   # abort released it already
            raise threading.BrokenBarrierError from None

    def wait(self, rank: int) -> None:
        """A collective: pass the turn on and take it back once every slot
        has reached this point."""
        self.give(rank)
        self.take(rank)

    def abort(self) -> None:
        self._broken = True
        for turn in self._turns:
            if turn.locked():
                try:
                    turn.release()
                except RuntimeError:   # released by another slot meanwhile
                    pass


def tensors(obj):
    """The tensors in ``obj`` (a tensor, or dicts, lists and tuples of
    them)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensors(v)


def refill(obj, it):
    """``obj`` with each of its tensors replaced by the next of ``it``
    (dicts, lists and tuples rebuilt), in the order of :func:`tensors`."""
    if isinstance(obj, torch.Tensor):
        return next(it)
    if isinstance(obj, dict):
        return {k: refill(v, it) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(refill(v, it) for v in obj)
    return obj


#: the reference's five collective kinds (``launch/hlo_analysis.py``), as
#: :attr:`Comm.log` records them
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(obj))


class Comm:
    """One slot's view of a :func:`run`: its coordinates on the mesh and the
    collectives over named mesh axes. ``axes`` is an axis name, a tuple of
    them (the group's order is row-major over the tuple, as a spec entry's
    shards are) or None (a group of one). Every slot must call the same
    collectives in the same order, as a per-rank program does.

    ``log``, None by default, may be set to a list: each collective of a
    group of more than one slot then appends (its kind, one of
    :data:`COLLECTIVES`, and the bytes of its output on this slot).

    ``tape``, None by default, may be set to a :class:`Tape`: while it
    records, every collective on an input that needs a gradient is a
    boundary of it, and its adjoint runs when the tape's backward reaches
    it (all-reduce ↔ all-reduce, all-gather ↔ reduce-scatter, all-to-all ↔
    the reverse all-to-all)."""

    def __init__(self, mesh: Mesh, index: tuple, rendezvous: Optional[_Rendezvous]):
        self.mesh, self.index = mesh, tuple(index)
        self.coord = dict(zip(mesh.axis_names, self.index))
        self.rank = int(np.ravel_multi_index(self.index, mesh.slots.shape))
        self.slot = mesh.slots[self.index]
        self.device = self.slot.device
        self._rv = rendezvous
        self._turn = 0
        self._groups: dict = {}
        self.log: Optional[list] = None
        self.tape: Optional[Tape] = None

    def share(self, entry, **at) -> tuple:
        """(shard index, shard count) of this slot along a spec entry, or
        of the slot at this one's coordinates with those in ``at``
        replaced (``share(entry, model=2)``)."""
        if entry is None:
            return 0, 1
        return _split_index(entry, {**self.coord, **at}, self.mesh.shape)

    def group(self, axes) -> list:
        """Flat ranks of the slots that share every coordinate but ``axes``
        with this one, in the order of their shard index along ``axes``."""
        if axes not in self._groups:
            self._groups[axes] = self._group(axes_of(axes))
        return self._groups[axes]

    def _group(self, axes: tuple) -> list:
        sizes = [self.mesh.shape[a] for a in axes]
        out = []
        for k in range(int(np.prod(sizes))):
            c = {**self.coord, **dict(zip(axes, np.unravel_index(k, sizes)))}
            out.append(int(np.ravel_multi_index(tuple(c[a] for a in self.mesh.axis_names),
                                                self.mesh.slots.shape)))
        return out

    def _record(self, kind: str, out) -> None:
        if self.log is not None:
            self.log.append((kind, _nbytes(out)))

    def _exchange(self, payload, axes) -> list:
        """Every member's ``payload`` (tensors, or lists, tuples and dicts of
        them), in group order. A peer's tensors are read on this slot's
        stream after the work that made them on the peer's: the stream
        waits for an event the peer recorded, and the caching allocator
        keeps each tensor until this stream has read it."""
        group = self.group(axes)
        if len(group) == 1:
            return [payload]
        event = None
        if self.slot.stream is not None:
            event = torch.cuda.Event()
            event.record(self.slot.stream)
        board = self._rv.boards[self._turn]
        self._turn ^= 1
        board[self.rank] = (payload, event)
        self._rv.wait(self.rank)
        got = [board[r] for r in group]
        if self.slot.stream is not None:
            cur = torch.cuda.current_stream(self.device)
            for r, (obj, ev) in zip(group, got):
                if r != self.rank and ev is not None:
                    cur.wait_event(ev)
                    for t in tensors(obj):
                        if t.is_cuda:
                            t.record_stream(cur)
        return [obj for obj, _ in got]

    def exchange(self, payload, axes) -> list:
        """Every member's ``payload`` in group order (an all-gather that
        keeps the members apart; not differentiable)."""
        got = self._exchange(payload, axes)
        if len(got) > 1:
            self._record("all-gather", got)
        return got

    def _node(self, xs: tuple, fwd, adjoint):
        """``fwd(*xs)`` (a tuple of tensors), a boundary of :attr:`tape`
        where it records and an input needs a gradient."""
        tape = self.tape
        if (tape is None or not tape.recording or not torch.is_grad_enabled()
                or not any(x.requires_grad for x in xs)):
            return fwd(*xs)
        return tape.boundary(xs, fwd, adjoint)

    def all_reduce(self, x, axes):
        """The sum of the group's ``x`` (a tensor, or a tuple of them summed
        each in one collective), added in group order from the first
        (every member gets the same bits)."""
        if len(self.group(axes)) == 1:
            return x
        xs = x if isinstance(x, tuple) else (x,)
        out = self._node(xs, lambda *ts: self._sum(ts, axes),
                         lambda *gs: self._sum(gs, axes))
        return out if isinstance(x, tuple) else out[0]

    def _sum(self, xs: tuple, axes) -> tuple:
        got = self._exchange(xs, axes)
        out = []
        for i in range(len(xs)):
            total = got[0][i].to(self.device)
            for g in got[1:]:
                total = total + g[i].to(self.device)
            out.append(total)
        out = tuple(out)
        self._record("all-reduce", out)
        return out

    def all_max(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The elementwise max of the group's ``x`` (not differentiable)."""
        got = self._exchange(x.detach(), axes)
        if len(got) == 1:
            return got[0]
        out = torch.stack([g.to(self.device) for g in got]).amax(dim=0)
        self._record("all-reduce", out)
        return out

    def all_gather(self, x, axes, dim, parts: int = 1):
        """The group's ``x`` concatenated along ``dim`` in group order (a
        tuple of tensors: each gathered, in one collective, along ``dim``
        or its own entry of a tuple ``dim``); with ``parts`` > 1 each
        member's ``x`` holds its share of that many parts (:func:`piece`),
        and the result is the parts in order."""
        if len(self.group(axes)) == 1:
            return x
        xs = x if isinstance(x, tuple) else (x,)
        dims = dim if isinstance(dim, tuple) else (dim,) * len(xs)
        out = self._node(xs, lambda *ts: self._gather(ts, axes, dims, parts),
                         lambda *gs: self.reduce_scatter(gs, axes, dims, parts))
        return out if isinstance(x, tuple) else out[0]

    def _gather(self, xs: tuple, axes, dims: tuple, parts: int) -> tuple:
        got = self._exchange(xs, axes)
        out = tuple(self._joined([g[i] for g in got], d, parts) for i, d in enumerate(dims))
        self._record("all-gather", out)
        return out

    def _joined(self, pieces: list, dim: int, parts: int) -> torch.Tensor:
        if len(pieces) == 1:
            return pieces[0]
        pieces = [p.to(self.device) for p in pieces]
        if parts > 1:
            split = [torch.chunk(p, parts, dim=dim) for p in pieces]
            pieces = [s[i] for i in range(parts) for s in split]
        return torch.cat(pieces, dim=dim)

    def reduce_scatter(self, xs: tuple, axes, dims: tuple, parts: int = 1) -> tuple:
        """The adjoint of :meth:`all_gather`: of each tensor of ``xs`` (each
        the shape of a gathered one), this member's share along its dim,
        summed over the group in group order (not differentiable)."""
        group = self.group(axes)
        n, me = len(group), group.index(self.rank)
        got = self._exchange(tuple(x.detach() for x in xs), axes)
        out = []
        for i, d in enumerate(dims):
            def mine(t):
                return torch.cat([torch.chunk(c, n, dim=d)[me]
                                  for c in torch.chunk(t.to(self.device), parts, dim=d)], dim=d)
            total = mine(got[0][i])
            for g in got[1:]:
                total = total + mine(g[i])
            out.append(total)
        out = tuple(out)
        if n > 1:
            self._record("reduce-scatter", out)
        return out

    def all_to_all(self, chunks: Sequence, axes, dim: int) -> torch.Tensor:
        """``chunks[k]`` goes to the group's k-th member; returns what every
        member sent this one, concatenated along ``dim`` in group order."""
        group = self.group(axes)
        if len(chunks) != len(group):
            raise ValueError(f"all_to_all: {len(chunks)} chunks for a group of {len(group)}")
        if len(group) == 1:
            return chunks[0]
        sizes = []

        def fwd(*cs):
            got = self._to_all(cs, axes)
            sizes[:] = [g.shape[dim] for g in got]
            return (torch.cat(got, dim=dim),)

        def back(g):
            return self._to_all(tuple(torch.split(g, sizes, dim=dim)), axes)

        return self._node(tuple(chunks), fwd, back)[0]

    def _to_all(self, chunks: tuple, axes) -> tuple:
        group = self.group(axes)
        me = group.index(self.rank)
        got = self._exchange(tuple(c.detach() for c in chunks), axes)
        out = tuple(g[me].to(self.device) for g in got)
        self._record("all-to-all", out)
        return out

    def permute(self, x, axes, shift: int = 1):
        """The reference's ``lax.ppermute`` over a cycle: this member's
        ``x`` (a tensor or a tuple of them) goes to the member ``shift``
        places on along ``axes`` (in group order, cyclically), and what the
        member ``shift`` places back sent comes back, on this slot's
        device. The members' tensors may differ in shape, not in number,
        rank or dtype. Every member calls it, idle or not (not
        differentiable)."""
        n = len(self.group(axes))
        if n == 1 or shift % n == 0:
            return x
        xs = x if isinstance(x, tuple) else (x,)
        out = self._permute(tuple(t.detach() for t in xs), axes, shift % n)
        self._record("collective-permute", out)
        return out if isinstance(x, tuple) else out[0]

    def _permute(self, xs: tuple, axes, shift: int) -> tuple:
        group = self.group(axes)
        got = self._exchange(xs, axes)[(group.index(self.rank) - shift) % len(group)]
        return tuple(t.to(self.device) for t in got)


class RecordingComm(Comm):
    """A communicator that records instead of sending: one rank of a mesh
    traced alone (the dry run). Each collective appends its kind and this
    rank's output bytes to :attr:`log`, as :class:`Comm` does, and returns
    tensors of the shapes the real exchange returns, on the input's device
    (``meta`` in the dry run). Every member is taken to send what this rank
    sends: the per-rank program is one program on every rank, and every
    tensor it exchanges is a shard that ``spec_for`` placed (an axis only
    where it divides the dim) or a slice all members cut alike. Where a
    rank's pieces for its peers differ in shape (an all-to-all of ragged
    chunks), what the peers send it is unknown, and it raises."""

    def __init__(self, mesh: Mesh, index: tuple):
        super().__init__(mesh, index, None)
        self.log = []

    def _exchange(self, payload, axes) -> list:
        return [payload] * len(self.group(axes))

    def _to_all(self, chunks: tuple, axes) -> tuple:
        if len({tuple(c.shape) for c in chunks}) > 1:
            raise ValueError("RecordingComm: an all-to-all of chunks of different shapes "
                             f"{[tuple(c.shape) for c in chunks]}: the peers' are unknown")
        return super()._to_all(chunks, axes)


class LocalComm:
    """The communicator of a model that is not sharded: one slot, every
    collective the identity. The layer functions take it by default, so a
    :class:`~repro_torch.models.model.CausalLM` and a sharded model run the
    same code."""

    def share(self, entry, **at) -> tuple:
        return 0, 1

    def exchange(self, payload, axes) -> list:
        return [payload]

    def all_reduce(self, x, axes):
        return x

    def all_max(self, x, axes):
        return x.detach()

    def all_gather(self, x, axes, dim, parts: int = 1):
        return x

    def all_to_all(self, chunks: Sequence, axes, dim: int):
        return chunks[0]

    def permute(self, x, axes, shift: int = 1):
        return x


LOCAL = LocalComm()


# ---------------------------------------------------------------------------
# Gradients across collectives: a tape of segments
# ---------------------------------------------------------------------------
def _rebuilt(fn, obj):
    """``obj`` with ``fn`` applied to each tensor in it, its lists and
    tuples rebuilt."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if type(obj) in (list, tuple):
        return type(obj)(_rebuilt(fn, o) for o in obj)
    return obj


class Tape:
    """The backward of one slot's per-rank program, run in the slot's own
    thread.

    PyTorch's autograd engine runs a CUDA graph's backward nodes on one
    worker thread per device, not on the caller's: a collective inside a
    backward node would wait there for its peers, which share that thread
    when several slots share a card. So no collective is an autograd node.
    Each collective on an input that needs a gradient is a *boundary*
    (:meth:`boundary`): its inputs end a segment of the graph, its outputs
    are new leaves that start the next, and its adjoint is recorded beside
    them. While the tape is entered (``with tape:``) a
    ``TorchFunctionMode`` tags every tensor an op makes with its segment,
    and an op of a later segment that reads it reads a leaf cut from it
    instead, so no segment's graph reaches into another's. :meth:`backward`
    walks the segments from the last: ``torch.autograd.grad`` over one
    segment in the calling thread, then the adjoint of the boundary that
    opened it (a collective, in the slot's thread under the rendezvous's
    turn), and so on down to the first. Every node runs once.

    Gradients follow one rule: every slot's gradient is its part of the
    whole, and a replicated tensor's is the sum of its copies' parts. So
    each collective's adjoint is fixed (all-reduce ↔ all-reduce, all-gather
    ↔ reduce-scatter, all-to-all ↔ the reverse all-to-all), the loss, which
    every slot holds whole, is seeded with 1 / (slots), and a parameter's
    gradient is summed over the mesh axes its spec does not shard.

    :meth:`remat` runs a region without a graph and, when the backward
    reaches it, again with one on a tape of its own, collectives included,
    as the reference's remat recomputes its collectives. An exchanged
    payload is always detached, so no slot's graph reaches a peer's."""

    def __init__(self, comm=None):
        self.comm = comm
        self.token = object()      # tags this tape's tensors (holds no tape)
        self.seg = 0
        self.recording = True
        self.nodes: list = []      # (inputs, output leaves, adjoint) per boundary
        self.exports: list = [[]]  # per segment: its tensors read later
        self.used: list = [{}]     # per segment: the leaves its ops read
        self._alias: dict = {}     # id(cut leaf) -> the tensor it was cut from
        self._cuts: dict = {}      # id(tensor) -> its cut leaf
        self._exported: set = set()
        self.grads: dict = {}      # id(tensor) -> (tensor, gradient)
        self._mode = None

    # -- forward ------------------------------------------------------------
    def __enter__(self):
        from torch.overrides import TorchFunctionMode

        tape = self

        class _Segments(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if tape.recording:
                    args = _rebuilt(tape._read, args)
                    if kwargs:
                        kwargs = {k: _rebuilt(tape._read, v) for k, v in kwargs.items()}
                out = func(*args, **kwargs)
                if tape.recording:
                    for t in tensors(out):
                        tape._tag(t)
                return out

        self._mode = _Segments()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None

    def _seg_of(self, t) -> int:
        tag = getattr(t, "_tape_seg", None)
        if tag is None or tag[0] is not self.token:   # an autograd.Function's output
            t._tape_seg = tag = (self.token, self.seg)
        return tag[1]

    def _tag(self, t):
        if isinstance(t, torch.Tensor) and t.grad_fn is not None:
            self._seg_of(t)
        return t

    def _read(self, t):
        """What an op of the current segment reads for ``t``: ``t``, or the
        leaf cut from it where an earlier segment made it."""
        if not isinstance(t, torch.Tensor) or not t.requires_grad:
            return t
        if t.grad_fn is None:
            self.used[self.seg][id(t)] = t
            return t
        seg = self._seg_of(t)
        if seg == self.seg:
            return t
        leaf = self._cuts.get(id(t))
        if leaf is None:
            leaf = t.detach().requires_grad_()
            self._cuts[id(t)] = leaf
            self._alias[id(leaf)] = t
            self._export(t, seg)
        self.used[self.seg][id(leaf)] = leaf
        return leaf

    def _export(self, t, seg: int) -> None:
        if id(t) not in self._exported:
            self._exported.add(id(t))
            self.exports[seg].append(t)

    def _next(self) -> None:
        self.seg += 1
        self.exports.append([])
        self.used.append({})

    def boundary(self, xs: tuple, fwd, adjoint) -> tuple:
        """``fwd(*xs)`` (a tuple of tensors) on the inputs detached: the
        outputs are leaves of a new segment, ``adjoint(*output grads)`` the
        inputs' gradients."""
        for x in xs:
            if x.requires_grad and x.grad_fn is not None:
                self._export(x, self._seg_of(x))
        ys = tuple(y.requires_grad_() if y.is_floating_point() else y
                   for y in fwd(*(x.detach() for x in xs)))
        self.nodes.append((xs, ys, adjoint))
        self._next()
        return ys

    def remat(self, fn, xs: tuple) -> tuple:
        """``fn(*xs)`` (a tuple of tensors) run now without a graph, and
        again with one when the backward reaches it."""
        if not (self.recording and torch.is_grad_enabled()):
            return fn(*xs)
        self.recording = False
        try:
            with torch.no_grad():
                out = fn(*(x.detach() for x in xs))
        finally:
            self.recording = True
        return self.boundary(xs, lambda *_: out, lambda *gs: self._rerun(fn, xs, gs))

    # -- backward -----------------------------------------------------------
    def _add(self, t, g) -> None:
        if g is None or not t.requires_grad:
            return
        t = self._alias.get(id(t), t)
        hit = self.grads.get(id(t))
        self.grads[id(t)] = (t, g if hit is None else hit[1] + g)

    def _grad_of(self, t):
        hit = self.grads.pop(id(t), None)
        return torch.zeros_like(t) if hit is None else hit[1]

    def backward(self, roots: tuple, seeds: tuple) -> None:
        """Propagate ``seeds`` from ``roots`` through every segment and
        boundary; :attr:`grads` then holds each leaf's gradient
        (:meth:`grad`)."""
        self.recording = False
        for t, g in zip(roots, seeds):
            if t.grad_fn is not None:
                self._export(t, self._seg_of(t))
            self._add(t, g)
        for s in range(self.seg, -1, -1):
            self._propagate(s)
            if s:
                xs, ys, adjoint = self.nodes[s - 1]
                for x, g in zip(xs, adjoint(*[self._grad_of(y) for y in ys])):
                    self._add(x, g)
                self.nodes[s - 1] = None

    def _propagate(self, s: int) -> None:
        roots = [(t, self.grads.pop(id(t))[1]) for t in self.exports[s] if id(t) in self.grads]
        want = list(self.used[s].values())
        for t in self.exports[s]:   # nothing reads these again: let them go
            self._exported.discard(id(t))
            leaf = self._cuts.pop(id(t), None)
            if leaf is not None:
                self._alias.pop(id(leaf), None)
        self.exports[s], self.used[s] = [], {}
        if not roots or not want:
            return
        got = torch.autograd.grad([t for t, _ in roots], want, [g for _, g in roots],
                                  allow_unused=True)
        for leaf, g in zip(want, got):
            self._add(leaf, g)

    def grad(self, t):
        """The gradient the backward left for leaf ``t`` (None: none)."""
        hit = self.grads.get(id(t))
        return None if hit is None else hit[1]

    def _rerun(self, fn, xs: tuple, gys: tuple) -> tuple:
        comm = self.comm
        sub = Tape(comm)
        leaves = tuple(x.detach().requires_grad_() if x.requires_grad else x for x in xs)
        prev = None if comm is None else comm.tape
        if comm is not None:
            comm.tape = sub
        try:
            with sub:
                out = fn(*leaves)
            sub.backward(out, gys)
        finally:
            if comm is not None:
                comm.tape = prev
        mine = {id(x) for x in leaves}
        for t, g in sub.grads.values():
            if id(t) not in mine:
                self._add(t, g)
        return tuple(sub.grad(x) for x in leaves)



def sharded(specs: Optional[dict], name: str, dim: int) -> bool:
    """Whether weight ``name``'s dim ``dim`` is split over the mesh under
    ``specs`` (None: a model that is not sharded)."""
    return specs is not None and specs[name][dim] is not None


_ctx = threading.local()


@contextlib.contextmanager
def activate(mesh: Mesh, rules: dict):
    """Inside this context a sharded model's entry points run the per-rank
    program over ``mesh`` with ``rules`` (:func:`run` hands both to every
    slot's thread, where :func:`hint` reads them); outside it, ``hint``
    returns its tensor unchanged."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, rules)
    try:
        yield
    finally:
        _ctx.state = prev


@contextlib.contextmanager
def acting_as(comm):
    """Inside this context the calling thread is ``comm``'s slot for
    :func:`hint` (as :func:`run` makes each slot's thread): the dry run
    traces one rank with a :class:`RecordingComm` this way."""
    prev = getattr(_ctx, "comm", None)
    _ctx.comm = comm
    try:
        yield
    finally:
        _ctx.comm = prev


def current_state():
    """(mesh, rules) under :func:`activate`, else None."""
    return getattr(_ctx, "state", None)


def current_comm():
    """The calling thread's communicator in :func:`run` or
    :func:`acting_as`, else None."""
    return getattr(_ctx, "comm", None)


def active_spec(shape: Sequence[int], axes: Sequence) -> tuple:
    """``spec_for(shape, axes)`` under the active mesh and rules."""
    mesh, rules = _ctx.state
    return spec_for(shape, axes, rules, mesh.shape)


def run(mesh: Mesh, fn) -> np.ndarray:
    """``fn(comm)`` once a slot, each in a thread of its own with the slot's
    device and stream current, one slot at a time between collectives (see
    :class:`_Rendezvous`); returns the results in a mesh-shaped object
    array. A slot that raises breaks the collectives' barrier; once every
    thread has ended the first exception (in slot order) is raised, or,
    where slots only timed out at a collective, a RuntimeError. Run under
    :func:`activate` for :func:`hint` to re-place tensors."""
    state = getattr(_ctx, "state", None)
    rv = _Rendezvous(mesh.size)
    idxs = list(np.ndindex(mesh.slots.shape))
    results, errors = [None] * len(idxs), [None] * len(idxs)

    def work(i: int) -> None:
        comm = Comm(mesh, idxs[i], rv)
        _ctx.state, _ctx.comm = state, comm
        try:
            if i:
                rv.take(i)
            with comm.slot.scope():
                results[i] = fn(comm)
            rv.give(i)
        except BaseException as e:   # every failure ends the run; re-raised below
            errors[i] = e
            rv.abort()

    threads = [threading.Thread(target=work, args=(i,), name=f"slot{i}", daemon=True)
               for i in range(len(idxs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [e for e in errors if e is not None]
    real = [e for e in failed if not isinstance(e, threading.BrokenBarrierError)]
    if real:
        raise real[0]
    if failed:
        raise RuntimeError(f"a collective of the per-rank program waited past "
                           f"{rv.timeout} s for a slot") from failed[0]
    out = np.empty(mesh.slots.shape, dtype=object)
    for i, idx in enumerate(idxs):
        out[idx] = results[i]
    return out


def reshard(x: torch.Tensor, src: Sequence, dst: Sequence, comm: Comm) -> torch.Tensor:
    """This slot's shard of a tensor placed by spec ``src`` (``x``), as the
    same tensor placed by spec ``dst``: each dim whose entries differ is
    gathered over its ``src`` axes, then split by its ``dst`` ones."""
    src, dst = _full_spec(src, x.ndim), _full_spec(dst, x.ndim)
    for dim, (a, b) in enumerate(zip(src, dst)):
        if a == b:
            continue
        if a is not None:
            x = comm.all_gather(x, a, dim)
        if b is not None:
            k, n = comm.share(b)
            x = torch.tensor_split(x, n, dim=dim)[k]
    return x


def hint(x: torch.Tensor, axes: Sequence, src: Optional[Sequence] = None) -> torch.Tensor:
    """Inside a slot's thread of the per-rank program: this slot's shard of
    ``x`` placed by ``spec_for``'s placement of logical ``axes``, where
    ``x`` is the slot's shard under spec ``src`` (None: replicated; the
    global shape is the shard's times the count along each sharded dim).
    Outside :func:`activate`, ``x`` unchanged."""
    state, comm = getattr(_ctx, "state", None), getattr(_ctx, "comm", None)
    if state is None or comm is None:
        return x
    src = _full_spec(src or (), x.ndim)
    full = [n * comm.share(e)[1] for n, e in zip(x.shape, src)]
    return reshard(x, src, active_spec(full, axes), comm)
