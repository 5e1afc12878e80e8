"""S-DP (arXiv:2008.01938, Definition 1): instances drawn from the seed,
the plain reference, and the comparison that decides ``correct``.

    ST[i] = min_j ST[i - a_j]     (i >= a_1; ST[0:a_1] = init)

The reference is plain PyTorch and imports nothing of the program. It
solves the table in blocks of a_k cells (every cell of a block reads only
cells before it), gathering each cell's k candidates and folding them with
one ``amin``/``amax``; min and max are exact, so the float32 reference is
the table bit for bit. The witness chain is walked on the host from the
last cell: each cell takes the first offset (the largest a_j) that attains
its value, as ``np.argmin``/``np.argmax`` pick it, down to the preset cell
the optimum flows from.
"""
from __future__ import annotations

import numpy as np
import torch

from bench import roofline

#: answers the reference solves at a time
BLOCK = 16
#: the precision below the configurations' float32, for the control
CONTROL_DTYPE = torch.bfloat16

def offsets(config: dict) -> tuple:
    """Table I's offsets ``range(2k, k, -1)``: a_1 = 2k down to a_k = k + 1."""
    k = int(config["k"])
    return tuple(range(2 * k, k, -1))


def draw(config: dict, rng: np.random.Generator, count: int) -> list:
    """``count`` request payloads: each ``init`` a_1 float32 values from
    ``rng``, so every request is distinct."""
    offs = offsets(config)
    inits = rng.standard_normal((count, offs[0]), dtype=np.float32)
    return [dict(init=row, offsets=offs, op=config["op"], n=int(config["n"]))
            for row in inits]


def work(config: dict) -> tuple:
    """(bytes, operations) of one request's solve with its arguments."""
    return roofline.sdp_work(int(config["n"]), offsets(config), False, True)


def reference_tables(inits: np.ndarray, offs: tuple, op: str, n: int,
                     device, dtype=torch.float32) -> torch.Tensor:
    """The ``(batch, n)`` tables of ``inits`` (``(batch, a_1)``) in ``dtype``
    on ``device``, a block of a_k cells at a time."""
    a = torch.as_tensor(offs, dtype=torch.int64, device=device)
    a1, ak = int(offs[0]), int(offs[-1])
    batch = inits.shape[0]
    st = torch.empty((batch, n), dtype=dtype, device=device)
    st[:, :a1] = torch.as_tensor(inits, device=device).to(dtype)
    rel = torch.arange(ak, device=device)[:, None] - a[None, :]
    fold = torch.amin if op == "min" else torch.amax
    for s in range(a1, n, ak):
        m = min(ak, n - s)
        idx = (rel[:m] + s).reshape(-1)
        st[:, s:s + m] = fold(st.index_select(1, idx).view(batch, m, len(offs)), dim=2)
    return st


def walk(table: np.ndarray, offs: tuple, op: str) -> dict:
    """The witness chain of the last cell over a finished table."""
    a = np.asarray(offs, dtype=np.int64)
    pick = np.argmin if op == "min" else np.argmax
    cells, taken = [], []
    cur = len(table) - 1
    while cur >= a[0]:
        j = int(pick(table[cur - a]))
        cells.append(cur)
        taken.append(int(a[j]))
        cur -= int(a[j])
    return {"cells": cells, "offsets_taken": taken, "terminal": cur}


def _same_path(got, want: dict) -> bool:
    try:
        return ([int(x) for x in got["cells"]] == want["cells"]
                and [int(x) for x in got["offsets_taken"]] == want["offsets_taken"]
                and int(got["terminal"]) == want["terminal"])
    except (KeyError, TypeError, ValueError):
        return False


def compare(samples: list, config: dict, device, limits: dict) -> dict:
    """The numbers compared over ``samples`` (each ``(payload, table,
    solution)`` as the timed path answered it): ``table_gap``, the widest
    gap between an answered table and the reference's, and ``path_diffs``,
    the answers whose witness chain (cells, offsets taken, terminal)
    differs from the reference's; and ``wrong``, the answers outside either
    limit. Runs the reference ``BLOCK`` answers at a time."""
    offs, op, n = offsets(config), config["op"], int(config["n"])
    gap, diffs, wrong = 0.0, 0, 0
    for lo in range(0, len(samples), BLOCK):
        part = samples[lo:lo + BLOCK]
        inits = np.stack([np.asarray(p["init"], np.float32) for p, _, _ in part])
        ref = reference_tables(inits, offs, op, n, device)
        for row, (_, table, solution) in zip(ref, part):
            got = torch.tensor(np.asarray(table, np.float32).ravel(), device=device)
            if got.shape != row.shape:
                g = float("inf")
            else:
                d = (got.double() - row.double()).abs()
                g = float(torch.nan_to_num(d, nan=float("inf")).max())
            same = _same_path(solution, walk(row.cpu().numpy(), offs, op))
            gap, diffs = max(gap, g), diffs + (not same)
            wrong += (g > limits["table_gap"]) or not same
        del ref
    return {"table_gap": gap, "path_diffs": diffs, "wrong": wrong}


def control_answers(payloads: list, config: dict, device) -> list:
    """The reference put in the program's place one precision lower:
    ``(payload, table, solution)`` computed in ``CONTROL_DTYPE``, the table
    read back as float32."""
    offs, op, n = offsets(config), config["op"], int(config["n"])
    inits = np.stack([np.asarray(p["init"], np.float32) for p in payloads])
    low = reference_tables(inits, offs, op, n, device, CONTROL_DTYPE).float().cpu().numpy()
    return [(p, t, walk(t, offs, op)) for p, t in zip(payloads, low)]
