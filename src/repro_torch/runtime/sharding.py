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

The reference's trace-time ``activate``/``hint`` pair is not ported: the
port's models carry no sharding hints, which are no-ops without a mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
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


def place(x, mesh: Mesh, spec: Sequence) -> np.ndarray:
    """``x`` (a tensor or numpy array) over ``mesh``: a mesh-shaped object
    array holding each slot's shard on the slot's device. Each dim whose
    spec entry names mesh axes is split by ``tensor_split`` into as many
    parts as those axes hold slots; the shards are replicated across the
    other axes. A copy to a card is issued on the slot's stream, so the
    slot's later work is ordered after it."""
    t = (torch.from_numpy(np.require(x, requirements="C"))
         if isinstance(x, (np.ndarray, np.generic)) else x)
    spec = _full_spec(spec, t.ndim)
    out = np.empty(mesh.slots.shape, dtype=object)
    for idx in np.ndindex(mesh.slots.shape):
        coord = dict(zip(mesh.axis_names, idx))
        piece = t
        for dim, entry in enumerate(spec):
            if entry is not None:
                k, n = _split_index(entry, coord, mesh.shape)
                piece = torch.tensor_split(piece, n, dim=dim)[k]
        slot = mesh.slots[idx]
        slot.follow(piece)
        with slot.scope():
            out[idx] = piece.contiguous().to(slot.device)
    return out


def gather(placed: np.ndarray, mesh: Mesh, spec: Sequence,
           device=None) -> torch.Tensor:
    """The tensor that :func:`place` split, on ``device`` (default: the
    mesh's first slot's): shards concatenated along their dims in slot
    order, one replica of each taken from the slots at index 0 of the axes
    the spec does not name. Each shard's stream is joined first."""
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
        parts = entry if isinstance(entry, tuple) else (entry,)
        sizes = [mesh.shape[p] for p in parts]
        pieces = [build(dim + 1, {**coord, **dict(zip(parts, np.unravel_index(k, sizes)))})
                  for k in range(int(np.prod(sizes)))]
        return torch.cat(pieces, dim=dim)

    return build(0, {})
