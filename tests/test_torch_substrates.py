"""The port's data, checkpoint and fault-tolerance substrate against
``repro`` (CPU): ``SyntheticLM`` batches equal to the reference's, the
prefetcher's order, the checkpointer (round trip, bf16, gc, async), the
supervisor's scenarios of ``test_fault_tolerance.py`` that need no mesh
(the recovered run bit-equal to the failure-free one), and the training
CLI learning and resuming (``test_integration.py``'s cases, ``--device
cpu``)."""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.data.pipeline import Prefetcher, SyntheticLM, to_device  # noqa: E402
from repro_torch.runtime.fault_tolerance import FTConfig, InjectedFailure, Supervisor  # noqa: E402


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("frontend", [0, 3])
def test_synthetic_batches_equal_reference(frontend):
    mine = SyntheticLM(1000, 32, 4, seed=7, frontend_tokens=frontend, d_model=6)
    ref = JSyntheticLM(1000, 32, 4, seed=7, frontend_tokens=frontend, d_model=6)
    for i in (0, 5, 6):
        a, b = mine.batch(i), ref.batch(i)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    b5 = mine.batch(5)
    np.testing.assert_array_equal(b5["labels"][:, :-1], b5["tokens"][:, 1:])
    assert not np.array_equal(mine.batch(5)["tokens"], mine.batch(6)["tokens"])


def test_prefetcher_yields_in_order_and_to_device_casts():
    data = SyntheticLM(100, 8, 2, seed=1, frontend_tokens=2, d_model=4)
    pf = Prefetcher(iter(data), depth=2)
    got = [next(pf) for _ in range(3)]
    pf.close()
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["tokens"], data.batch(i)["tokens"])
    dev = to_device(got[0], "cpu")
    assert dev["tokens"].dtype == dev["labels"].dtype == torch.int64
    assert dev["frontend"].dtype == torch.float32
    np.testing.assert_array_equal(dev["tokens"].numpy(), got[0]["tokens"])


# ---------------------------------------------------------------------------
# Checkpointer
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = ({"a": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
            {"c": torch.randn(5).bfloat16(), "step": torch.tensor(7, dtype=torch.int32)})
    ck.save(3, tree, blocking=True)
    assert os.path.exists(tmp_path / "step_3" / "manifest.json")
    out = ck.restore(3, tree)
    assert out[1]["c"].dtype == torch.bfloat16 and torch.equal(out[1]["c"], tree[1]["c"])
    assert torch.equal(out[0]["a"], tree[0]["a"]) and out[0]["a"] is not tree[0]["a"]
    assert int(out[1]["step"]) == 7 and out[1]["step"].dtype == torch.int32
    with pytest.raises(ValueError, match="shape"):
        ck.restore(3, ({"a": torch.zeros(4, 3)}, tree[1]))


def test_checkpoint_gc_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 5, 9):
        ck.save(s, {"x": torch.zeros(3)}, blocking=True)
    assert ck.steps() == [5, 9]
    assert ck.latest_step() == 9


def test_checkpoint_async_snapshots_before_returning(tmp_path):
    """The save copies the tensors before it returns: an in-place update
    right after does not reach the files."""
    ck = Checkpointer(str(tmp_path))
    x = torch.arange(4.0)
    ck.save(1, {"x": x})
    x.add_(100.0)
    ck.wait()
    assert ck.latest_step() == 1
    assert torch.equal(ck.restore(1, {"x": x})["x"], torch.arange(4.0))


# ---------------------------------------------------------------------------
# Supervisor (test_fault_tolerance.py's scenarios without a mesh)
# ---------------------------------------------------------------------------
def quad_step(state, batch):
    w = state["w"]
    w = w - 0.1 * (2 * (w - batch))
    return {"w": w}, {"loss": ((w - batch) ** 2).sum()}


def batches(i):
    return torch.full((4,), float(i % 3))


def run_supervised(path, failure_hook, num_steps=25, ckpt_every=5):
    sup = Supervisor(quad_step, Checkpointer(str(path), keep=3),
                     FTConfig(checkpoint_every=ckpt_every, max_restarts=5),
                     failure_hook=failure_hook)
    final, log = sup.run({"w": torch.zeros(4)}, batches, 0, num_steps)
    return sup, final, log


def test_no_failures_baseline(tmp_path):
    sup, _, log = run_supervised(tmp_path, lambda s: None)
    assert len(log) == 25 and sup.stats.restarts == 0 and sup.stats.checkpoints >= 5


def test_recovery_resumes_and_matches_failure_free_run(tmp_path):
    fired = {"done": False}

    def hook(step):
        if step == 13 and not fired["done"]:
            fired["done"] = True
            raise InjectedFailure("node lost")

    sup, final, _ = run_supervised(tmp_path / "a", hook)
    assert sup.stats.restarts == 1 and sup.stats.steps_replayed > 0
    _, final2, _ = run_supervised(tmp_path / "b", lambda s: None)
    assert torch.equal(final["w"], final2["w"])


def test_recovery_counts_a_checkpoint_still_being_written(tmp_path, monkeypatch):
    """A failure right after a checkpoint is submitted, its write slowed
    down: recovery waits for it and restarts from that step (nothing
    replayed), not from the one before."""
    save = np.save

    def slow_save(*args, **kwargs):
        time.sleep(0.2)
        return save(*args, **kwargs)

    monkeypatch.setattr(np, "save", slow_save)
    fired = []

    def hook(step):
        if step == 5 and not fired:
            fired.append(step)
            raise InjectedFailure("node lost")

    sup, final, log = run_supervised(tmp_path, hook, num_steps=8)
    assert sup.stats.restarts == 1 and sup.stats.steps_replayed == 0
    assert [r["step"] for r in log] == list(range(8))


def test_multiple_failures(tmp_path):
    count = {"n": 0}

    def hook(step):
        if step in (7, 19) and count["n"] < 3:
            count["n"] += 1
            raise InjectedFailure(f"fail at {step}")

    sup, _, log = run_supervised(tmp_path, hook)
    assert sup.stats.restarts >= 2 and len(log) >= 25


def test_failure_budget_exhaustion(tmp_path):
    def hook(step):
        if step == 6:
            raise InjectedFailure("always")

    sup = Supervisor(quad_step, Checkpointer(str(tmp_path)),
                     FTConfig(checkpoint_every=5, max_restarts=2), failure_hook=hook)
    with pytest.raises(InjectedFailure):
        sup.run({"w": torch.zeros(4)}, batches, 0, 25)


def test_straggler_detection(tmp_path):
    sup = Supervisor(quad_step, Checkpointer(str(tmp_path)), FTConfig(straggler_factor=2.0))

    def slow(state, batch):
        if len(sup._durations) == 10:
            time.sleep(0.25)
        return quad_step(state, batch)

    sup.step_fn = slow
    sup.run({"w": torch.zeros(4)}, batches, 0, 15)
    assert sup.stats.stragglers >= 1


# ---------------------------------------------------------------------------
# The training CLI (test_integration.py's cases on the CPU)
# ---------------------------------------------------------------------------
def test_train_driver_learns_and_checkpoints(tmp_path):
    from repro_torch.launch.train import main

    metrics = tmp_path / "m.jsonl"
    loss = main(["--arch", "qwen3-14b", "--reduced", "--steps", "8", "--batch", "4",
                 "--seq", "64", "--ckpt-every", "4", "--ckpt-dir", str(tmp_path / "ck"),
                 "--metrics", str(metrics), "--device", "cpu"])
    assert np.isfinite(loss)
    rows = [json.loads(line) for line in open(metrics)]
    assert len(rows) == 8 and rows[-1]["loss"] < rows[0]["loss"]
    assert Checkpointer(str(tmp_path / "ck")).latest_step() == 8


def test_train_driver_resume(tmp_path):
    from repro_torch.launch.train import main

    ck_dir = str(tmp_path / "ck")
    common = ["--arch", "phi3-mini-3.8b", "--reduced", "--batch", "2", "--seq", "32",
              "--ckpt-dir", ck_dir, "--device", "cpu"]
    main(common + ["--steps", "6", "--ckpt-every", "3", "--metrics", str(tmp_path / "m1.jsonl")])
    before = Checkpointer(ck_dir).latest_step()
    assert before is not None and before >= 3
    main(common + ["--steps", "4", "--ckpt-every", "2", "--metrics", str(tmp_path / "m2.jsonl"),
                   "--resume"])
    after = Checkpointer(ck_dir).latest_step()
    assert after > before
    rows = [json.loads(line) for line in open(tmp_path / "m2.jsonl")]
    assert rows[0]["step"] == before
