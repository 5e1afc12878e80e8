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
``all_gather`` and ``all_to_all`` over named mesh axes. One slot runs at a
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


def _entries(entry) -> tuple:
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
        axes = _entries(entry)
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


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


class Comm:
    """One slot's view of a :func:`run`: its coordinates on the mesh and the
    collectives over named mesh axes. ``axes`` is an axis name, a tuple of
    them (the group's order is row-major over the tuple, as a spec entry's
    shards are) or None (a group of one). Every slot must call the same
    collectives in the same order, as a per-rank program does."""

    def __init__(self, mesh: Mesh, index: tuple, rendezvous: _Rendezvous):
        self.mesh, self.index = mesh, tuple(index)
        self.coord = dict(zip(mesh.axis_names, self.index))
        self.rank = int(np.ravel_multi_index(self.index, mesh.slots.shape))
        self.slot = mesh.slots[self.index]
        self.device = self.slot.device
        self._rv = rendezvous
        self._turn = 0
        self._groups: dict = {}

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
            self._groups[axes] = self._group(_entries(axes))
        return self._groups[axes]

    def _group(self, axes: tuple) -> list:
        sizes = [self.mesh.shape[a] for a in axes]
        out = []
        for k in range(int(np.prod(sizes))):
            c = {**self.coord, **dict(zip(axes, np.unravel_index(k, sizes)))}
            out.append(int(np.ravel_multi_index(tuple(c[a] for a in self.mesh.axis_names),
                                                self.mesh.slots.shape)))
        return out

    def exchange(self, payload, axes) -> list:
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
                    for t in _tensors(obj):
                        if t.is_cuda:
                            t.record_stream(cur)
        return [obj for obj, _ in got]

    def all_reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The sum of the group's ``x``, added in group order from the
        first (every member gets the same bits)."""
        parts = self.exchange(x, axes)
        total = parts[0].to(self.device)
        for p in parts[1:]:
            total = total + p.to(self.device)
        return total

    def all_gather(self, x, axes, dim: int, parts: int = 1):
        """The group's ``x`` concatenated along ``dim`` in group order (a
        tuple of tensors: each gathered, in one collective); with ``parts``
        > 1 each member's ``x`` holds its share of that many parts
        (:func:`piece`), and the result is the parts in order."""
        got = self.exchange(x, axes)
        if isinstance(x, tuple):
            return tuple(self._joined([g[i] for g in got], dim, parts) for i in range(len(x)))
        return self._joined(got, dim, parts)

    def _joined(self, pieces: list, dim: int, parts: int) -> torch.Tensor:
        if len(pieces) == 1:
            return pieces[0]
        pieces = [p.to(self.device) for p in pieces]
        if parts > 1:
            split = [torch.chunk(p, parts, dim=dim) for p in pieces]
            pieces = [s[i] for i in range(parts) for s in split]
        return torch.cat(pieces, dim=dim)

    def all_to_all(self, chunks: Sequence, axes, dim: int) -> torch.Tensor:
        """``chunks[k]`` goes to the group's k-th member; returns what every
        member sent this one, concatenated along ``dim`` in group order."""
        group = self.group(axes)
        if len(chunks) != len(group):
            raise ValueError(f"all_to_all: {len(chunks)} chunks for a group of {len(group)}")
        me = group.index(self.rank)
        got = self.exchange(list(chunks), axes)
        return torch.cat([g[me].to(self.device) for g in got], dim=dim)


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

    def all_gather(self, x, axes, dim: int, parts: int = 1):
        return x

    def all_to_all(self, chunks: Sequence, axes, dim: int):
        return chunks[0]


LOCAL = LocalComm()


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
