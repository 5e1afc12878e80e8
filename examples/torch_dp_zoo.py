"""DP zoo tour on the port: declarative problems, dispatch, batching, the
engine and calibration, on the card by default.

Run: ``PYTHONPATH=src python examples/torch_dp_zoo.py [--device cpu]``
"""
import argparse

import numpy as np

from repro_torch import dp


def chars(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8).astype(np.int64)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = dp.backends.resolve_device(ap.parse_args().device)
    print("registered problems:", ", ".join(dp.problem_names()))
    print("registered backends:", ", ".join(dp.backends.names()))

    # one-shot solves — dispatch picks the backend per problem shape
    d = dp.solve("edit_distance", x=chars("kitten"), y=chars("sitting"), device=dev)
    print(f"\nedit_distance(kitten, sitting) = {d:.0f} "
          f"[{dp.dispatch('edit_distance', device=dev, x=chars('kitten'), y=chars('sitting')).name}]")

    cost = dp.solve("mcm", dims=[30, 35, 15, 5, 10, 20, 25], device=dev)
    print(f"mcm CLRS example = {cost:.0f} (expect 15125)")

    best = dp.solve("unbounded_knapsack", item_weights=[3, 4],
                    item_values=[5.0, 6.0], capacity=10, device=dev)
    print(f"unbounded_knapsack = {best:.0f} (expect 16)")

    # reconstruct=True: answers, not just costs
    ans = dp.solve("mcm", dims=[30, 35, 15, 5, 10, 20, 25], reconstruct=True,
                   device=dev)
    print(f"\nmcm parenthesization = {ans.solution['string']} "
          f"(cost {ans.value:.0f}, args {ans.source}-side)")
    ans = dp.solve("edit_distance", x=chars("kitten"), y=chars("sitting"),
                   reconstruct=True, device=dev)
    script = " ".join(op[0] for op in ans.solution["ops"])
    print(f"edit script kitten→sitting: {script}")
    ans = dp.solve("unbounded_knapsack", item_weights=[3, 4],
                   item_values=[5.0, 6.0], capacity=10, reconstruct=True,
                   device=dev)
    print(f"knapsack items (weight, value): {ans.solution['items']}")

    # the grid family: alignment + parsing in native 2-D shape
    x, y = "GATTACA", "GCATGCU"
    ans = dp.solve("needleman_wunsch", x=chars(x), y=chars(y), match=1.0,
                   mismatch=-1.0, gap=-1.0, reconstruct=True, device=dev)
    top, bot = [], []
    for op in ans.solution["ops"]:
        if op[0] == "align":
            top.append(x[op[1]]); bot.append(y[op[2]])
        elif op[0] == "del":
            top.append(x[op[1]]); bot.append("-")
        else:
            top.append("-"); bot.append(y[op[1]])
    print(f"\nneedleman_wunsch {x} / {y} (score {ans.value:.0f}):")
    print(f"  {''.join(top)}\n  {''.join(bot)}")

    # CKY: S -> S S | A B over the sentence "a b a b"
    rules, rule_logp = [(0, 0, 0), (0, 1, 2)], [-0.4, -0.6]
    lex = np.full((3, 2), -50.0)
    lex[1, 0], lex[2, 1] = -0.2, -0.3          # A covers 'a', B covers 'b'
    ans = dp.solve("cky", tokens=[0, 1, 0, 1], rules=rules,
                   rule_logp=rule_logp, lex=lex, reconstruct=True, device=dev)
    print(f"cky parse of 'a b a b': {ans.solution['bracket']} "
          f"(logp {ans.value:.2f})")

    # batched: 32 same-shape instances, one solver call (one kernel launch
    # on the card)
    rng = np.random.default_rng(0)
    instances = [{"dims": rng.integers(1, 30, size=17).astype(np.float64)}
                 for _ in range(32)]
    before = sum(dp.telemetry.kernel_launches().values())
    answers = dp.batch_solve("mcm", instances, device=dev)
    print(f"\nbatch_solve: 32 MCM instances via "
          f"{dp.routing.select_batch_backend(dp.get_problem('mcm').encode(**instances[0]), device=dev).name}, "
          f"{sum(dp.telemetry.kernel_launches().values()) - before} kernel launch(es), "
          f"mean cost {np.mean(answers):.0f}")

    # the engine: heterogeneous traffic, bucketed into batched solves;
    # reconstruct requests get one batched traceback walk per bucket
    eng = dp.DPEngine(max_batch=16, device=dev)
    for _ in range(12):
        eng.submit("mcm", dims=rng.integers(1, 30, size=13).astype(np.float64))
    for _ in range(7):
        eng.submit("lcs", x=rng.integers(0, 4, size=9), y=rng.integers(0, 4, size=9))
    eng.submit("optimal_bst", freq=rng.random(10) + 0.01)
    bst_rid = eng.submit("optimal_bst", freq=rng.random(10) + 0.01,
                         reconstruct=True)
    out = eng.run()
    print(f"engine: {eng.stats['completed']} requests in "
          f"{eng.stats['device_batches']} device batches "
          f"(buckets keyed by problem × shape), "
          f"{eng.stats['device_tracebacks']} device-side traceback(s), "
          f"{eng.stats['feedback_observations']} latency observation(s) "
          f"fed back to routing")
    print("sample responses:", {r: round(out[r].answer, 2) for r in list(out)[:3]})
    print(f"reconstructed BST root tree: {out[bst_rid].solution.solution['tree']}")

    # measured-cost calibration: dispatch learns real latencies and stops
    # trusting the step-count model where it is measurably wrong
    dp.calibrate(problems=["viterbi", "edit_distance", "sdp"], sizes=(8, 16),
                 repeats=2, device=dev)
    rep = dp.routing_report(device=dev)
    print(f"\ncalibration: {len(rep['shapes'])} shapes measured on "
          f"{rep['platform']}, {rep['disagreements']} analytical pick(s) "
          f"overturned (median analytical regret "
          f"{rep['median_analytical_regret']:.2f}x)")
    for row in [r for r in rep["shapes"]
                if r["comparable"] and not r["agree"]][:3]:
        n = dp.backends.shape_key_size(row["shape_key"])
        print(f"  n={n}: measured {row['measured_choice']} beats analytical "
              f"{row['analytical_choice']} ({row['analytical_regret']:.1f}x "
              f"regret avoided)")


if __name__ == "__main__":
    main()
