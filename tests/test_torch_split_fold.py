"""The split-parallel fold of K2 (``mcm_pipeline``) and K6 spandiag
(``grid_pipeline``), modelled in PyTorch on the CPU, and the pure rules
their CUDA kernels mirror.

Both kernels rest on one fact: a strict-improve fold over the candidates
in ascending order equals a fold split over lanes (each lane a strict-
improve fold of its own candidates, in ascending order) merged by (value,
order key), the smaller key on equal values. A cell whose candidates are
all the semiring zero then keeps the smallest key: arg 0 for K2, the first
rule into the plane for K6. The models below deal the candidates to lanes
as the kernels do (by ``lanes_per_cell`` and ``spandiag_warps``), merge with
the kernels' xor butterfly, and must equal the plain versions, which fold
in order, bit for bit on tie-heavy integer weights and on all-zero cells.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import dp  # noqa: E402
from repro_torch.core.grid import batched, plane_lists, semiring_zero  # noqa: E402
from repro_torch.core.mcm import lin_index, num_cells  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import grid_pipeline as tk6  # noqa: E402
from repro_torch.kernels import mcm_pipeline as tk2  # noqa: E402
from test_torch_gpu import grid_arrs, grid_edge_specs  # noqa: E402

NO_KEY = 2 ** 31 - 1


def _rng(tag: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _lane_fold(vals, keys, lanes: int, better):
    """Candidates ``(..., m)`` in ascending key order dealt to ``lanes``
    lanes in turn (candidate k to lane k mod lanes), each lane folding its
    own by strict improvement from ``vals``' zero (the first entry of the
    ``zero`` fill below), then the lanes merged by the kernels' xor
    butterfly on (value, key). Returns (value, key), key NO_KEY where no
    candidate improved on the zero."""
    *lead, m = vals.shape
    per = -(-m // lanes)
    pad = per * lanes - m
    zero = vals.new_full((), float("inf") if better is torch.lt else float("-inf"))
    v = torch.cat([vals, zero.expand(*lead, pad)], -1).reshape(*lead, per, lanes)
    k = torch.cat([keys, keys.new_full((*lead, pad), NO_KEY)], -1).reshape(*lead, per, lanes)
    acc = zero.expand(*lead, lanes).clone()
    key = torch.full((*lead, lanes), NO_KEY, dtype=torch.int64)
    for u in range(per):                      # each lane's candidates, ascending
        take = better(v[..., u, :], acc)
        acc = torch.where(take, v[..., u, :], acc)
        key = torch.where(take, k[..., u, :], key)
    s = lanes // 2
    while s:                                  # the butterfly: lane l meets l ^ s
        partner = torch.arange(lanes) ^ s
        ov, ok = acc[..., partner], key[..., partner]
        take = better(ov, acc) | ((ov == acc) & (ok < key))
        acc, key = torch.where(take, ov, acc), torch.where(take, ok, key)
        s //= 2
    return acc[..., 0], key[..., 0]


def k2_split_model(wtab, n: int, lanes: int, with_args: bool = False):
    """K2's fold: per diagonal, each cell's splits dealt to a group of
    ``lanes_per_cell(d, n - d, lanes)`` lanes and merged by (value, split);
    an all-inf row keeps arg 0."""
    squeeze = wtab.dim() == 2
    if squeeze:
        wtab = wtab[None]
    st = torch.zeros((wtab.shape[0], num_cells(n)), dtype=wtab.dtype)
    ar = torch.full(st.shape, -1, dtype=torch.int32)
    for d in range(1, n):
        t = torch.arange(n - d)[:, None]
        e = torch.arange(d)[None, :]
        off_d = lin_index(0, d, n)
        vals = ((st[:, lin_index(0, e, n) + t]
                 + st[:, lin_index(0, d - e - 1, n) + e + 1 + t])
                + wtab[:, off_d + t, e])
        w = tk2.lanes_per_cell(d, n - d, lanes)
        best, key = _lane_fold(vals, e.expand_as(vals), w, torch.lt)
        st[:, off_d:off_d + n - d] = best
        ar[:, off_d:off_d + n - d] = torch.where(key == NO_KEY, 0, key).to(torch.int32)
    if squeeze:
        st, ar = st[0], ar[0]
    return (st, ar) if with_args else st


def k6_split_model(arrs, meta, ctas: int):
    """K6 spandiag's fold: per span diagonal, each (instance, targeted
    plane, cell) triple's candidates (split e, j-th rule into the plane),
    e-major, dealt to ``32 · spandiag_warps`` lanes and merged by (value,
    ``e·NR + r``); a triple none of whose candidates improves on the zero
    keeps the first rule into its plane. Returns ``(st, args)``."""
    _, op, P, n, _, _, rules = meta
    _, (rw, init) = batched(arrs, meta)
    B, NR = rw.shape[0], len(rules)
    zero = semiring_zero(op)
    better = torch.lt if op == "min" else torch.gt
    cells = num_cells(n)
    st = torch.full((B, P, cells), zero, dtype=rw.dtype)
    st[:, :, :n] = init
    ar = torch.full((B, P, cells), -1, dtype=torch.int32)
    by_plane = plane_lists(rules, P)
    live = [p for p in range(P) if by_plane[p]]
    most = max(len(lst) for lst in by_plane)
    for d in range(1, n):
        lanes, off_d = n - d, lin_index(0, d, n)
        g = tk6.spandiag_warps(d * most, B * len(live) * lanes, ctas)
        i = torch.arange(lanes)[:, None]
        e = torch.arange(d)[None, :]
        li, ri = lin_index(i, e, n), lin_index(i + e + 1, d - e - 1, n)   # (lanes, d)
        for A in live:
            rs = torch.tensor(by_plane[A])
            lb = torch.tensor([int(rules[r][1]) for r in by_plane[A]])
            rc = torch.tensor([int(rules[r][2]) for r in by_plane[A]])
            # (B, lanes, d, RA): split-major, the rules in declaration order
            vals = ((st[:, lb[None, None, :], li[..., None]]
                     + st[:, rc[None, None, :], ri[..., None]])
                    + rw[:, rs][:, None, None, :])
            keys = (e[..., None] * NR + rs).expand(lanes, d, len(rs))
            best, key = _lane_fold(vals.reshape(B, lanes, -1),
                                   keys.reshape(lanes, -1).expand(B, lanes, -1),
                                   32 * g, better)
            st[:, A, off_d:off_d + lanes] = best
            ar[:, A, off_d:off_d + lanes] = torch.where(
                key == NO_KEY, int(rs[0]), key).to(torch.int32)
    return st.reshape(B, -1), ar.reshape(B, -1)


# ---------------------------------------------------------------------------
# The pure rules
# ---------------------------------------------------------------------------
def test_k2_table_home_rule():
    """Shared memory for every width the L2 gate sends K2 (n ≤ 295) and up
    to the last that fits (340), device memory past it."""
    assert all(tk2.table_home(n) == "shared" for n in range(1, 296))
    assert tk2.table_home(340) == "shared" and tk2.table_home(341) == "device"
    assert tk2.smem_bytes(340) <= _build.SMEM_OPTIN_BYTES < tk2._table_bytes(341)
    assert tk2.smem_bytes(256) == 4 * num_cells(256) + tk2.MERGE_BYTES
    assert tk2.smem_bytes(1024) == tk2.MERGE_BYTES


@pytest.mark.parametrize("lanes", [1, 64, 512, 4096, 8192])
def test_k2_lanes_per_cell_rule(lanes):
    """A power of two up to THREADS, covering the splits where the cells
    leave room, never giving a cell a group where the cluster has none."""
    for n in (2, 33, 256, 1024):
        for d in range(1, n):
            w = tk2.lanes_per_cell(d, n - d, lanes)
            assert w & (w - 1) == 0 and 1 <= w <= tk2.THREADS
            assert w == 1 or (n - d) * w <= lanes
            if w < min(tk2.THREADS, d):                   # halved for the cells
                assert (n - d) * 2 * w > lanes
    assert tk2.lanes_per_cell(128, 128, 4096) == 32
    assert tk2.lanes_per_cell(250, 6, 4096) == 256
    assert tk2.lanes_per_cell(1, 255, 4096) == 1


def test_k2_pick_cluster():
    assert tk2.pick_cluster(8, {16: 7, 8: 16, 4: 33, 2: 66, 1: 132}) == 8
    assert tk2.pick_cluster(1, {16: 7, 8: 16, 4: 33, 2: 66, 1: 132}) == 16
    assert tk2.pick_cluster(40, {16: 7, 8: 16, 4: 33, 2: 66, 1: 132}) == 2
    assert tk2.pick_cluster(500, {16: 7, 8: 16, 4: 33, 2: 66, 1: 132}) == 1
    assert tk2.pick_cluster(3, {16: 0, 8: 2, 4: 4, 2: 8, 1: 16}) == 4


@pytest.mark.parametrize("ctas", [1, 132, 264])
def test_k6_spandiag_warps_rule(ctas):
    for cand in (1, 31, 32, 33, 100, 2016, 10 ** 5):
        for triples in (1, 7, 32, 2016, 10 ** 6):
            g = tk6.spandiag_warps(cand, triples, ctas)
            assert g & (g - 1) == 0 and 1 <= g <= tk6.SD_WARPS
            assert g == 1 or triples * g <= ctas * tk6.SD_WARPS
            if g < tk6.SD_WARPS and 32 * g < cand:        # halved for the triples
                assert triples * 2 * g > ctas * tk6.SD_WARPS
    # cky 64 x 32 x 1024 on 264 CTAs: the last diagonal's 32 triples get 16
    # warps each, the middle ones fewer
    assert tk6.spandiag_warps(63 * 32, 32, 264) == 16
    assert tk6.spandiag_warps(32 * 32, 32 * 32, 264) == 4


def test_k6_spandiag_smem_covers_4000_rules():
    assert tk6.spandiag_smem_bytes(8, 4000) <= _build.SMEM_OPTIN_BYTES - tk6._STATIC_SMEM
    assert tk6.spandiag_smem_bytes(32, 1024) == 16 * 1024 + 4 * 65 + 8 * tk6.SD_WARPS


# ---------------------------------------------------------------------------
# The split-parallel fold against the plain versions
# ---------------------------------------------------------------------------
def _k2_weights(n, batch, kind, tag):
    rng = _rng(tag)
    shape = (batch, num_cells(n), max(n - 1, 1))
    if kind == "ties":                 # small integers: equal candidates everywhere
        w = rng.integers(0, 3, shape).astype(np.float32)
    else:                              # rows whose every split is inf keep arg 0
        w = rng.normal(size=shape).astype(np.float32)
        w[:, rng.integers(n, num_cells(n), max(n // 2, 1))] = np.inf
    return torch.from_numpy(w)


@pytest.mark.parametrize("n", [2, 3, 9, 33, 70])
@pytest.mark.parametrize("lanes", [4, 64, 4096])
@pytest.mark.parametrize("kind", ["ties", "inf"])
def test_k2_split_fold_equals_plain(n, lanes, kind):
    w = _k2_weights(n, 2, kind, f"k2-split/{n}/{lanes}/{kind}")
    want_t, want_a = tk2.mcm_pipeline_plain(w, n, with_args=True)
    got_t, got_a = k2_split_model(w, n, lanes, with_args=True)
    assert torch.equal(got_t, want_t) and torch.equal(got_a, want_a)
    if kind == "inf":
        assert torch.isinf(got_t).any() and (got_a[torch.isinf(got_t)] == 0).all()


def _k6_cases():
    cases = [(label, spec) for label, spec in grid_edge_specs()
             if label.startswith("spandiag")]
    prob = dp.get_problem("cky")
    for n in (5, 9):
        rng = _rng(f"k6-split/{n}")
        P, NR = 4, 24
        # rules r -> plane r mod 3: plane 3 untargeted and -inf above the
        # words; plane 2's rules read it on the left, so every one of its
        # candidates is -inf (its args keep its first rule)
        rules = tuple((r % 3, 3 if r % 3 == 2 else int(rng.integers(0, 4)),
                       int(rng.integers(0, 4))) for r in range(NR))
        init = -rng.integers(1, 4, (P, n)).astype(np.float32)
        init[3] = -np.inf
        cases.append((f"ties-{n}", dp.GridSpec(
            rows=n, cols=n, op="max", schedule="spandiag", planes=P, rules=rules,
            rule_weights=-rng.integers(0, 2, NR).astype(np.float32), init=init)))
    for size in (4, 8):
        inst = prob.sample(_rng(f"k6-cky/{size}"), size)
        cases.append((f"cky-{size}", prob.encode(**inst)))
    return cases


@pytest.mark.parametrize("spec", [pytest.param(s, id=label) for label, s in _k6_cases()])
@pytest.mark.parametrize("ctas", [1, 3, 132])
def test_k6_split_fold_equals_plain(spec, ctas):
    meta = spec.static_meta()
    arrs = grid_arrs(spec, "cpu", batch=2)
    want_t, want_a = tk6.grid_pipeline_plain(arrs, meta, with_args=True)
    got_t, got_a = k6_split_model(arrs, meta, ctas)
    assert torch.equal(got_t, want_t) and torch.equal(got_a, want_a)
