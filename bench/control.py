#!/usr/bin/env python3
"""The control of a cell's check: the plain reference put in the program's
place, computed one precision below the configuration's (bfloat16 for
float32), and held against the float32 reference by the same comparison a
run makes, on as many answers as a run compares.

    python3 bench/control.py --workload <cell> --seeds 1 2 3

Prints one JSON line a seed with the numbers compared and their limits.
The benchmark's own runs never run it. A control that passes a limit is
the sign that the check cannot tell the lower precision apart.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(workload: str, seed: int, device, root: Path = ROOT, bench=None) -> dict:
    """The control's numbers for ``workload`` on ``seed``: the first answers
    of the run's own request stream, as many as a run compares."""
    from bench import harness, manifest

    man = manifest.Manifest(root, bench or manifest.BENCH)
    cell = man.cell(workload)
    config, traffic = man.config(cell["config"]), man.traffic(cell["traffic"])
    problem = man.problem(config["problem"])
    requests = harness.Requests(problem, config, seed, harness.WINDOW_STREAM)
    payloads = [requests(i) for i in range(int(traffic["sample"]))]
    answers = problem.control_answers(payloads, config, device)
    numbers = problem.compare(answers, config, device, config["check"])
    return {"workload": workload, "seed": seed,
            "numbers": {k: numbers[k] for k in config["check"] if k in numbers},
            "limits": config["check"], "wrong": numbers["wrong"], "compared": len(answers)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
