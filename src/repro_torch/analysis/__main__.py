"""CLI: ``python -m repro_torch.analysis [--gate] [--json PATH] [--device cpu]``.

Runs the schedule-hazard verifier, the extension-state proofs and the
registry contract linter over everything registered, on the card unless
``--device`` names another device, prints a summary, optionally writes the
structured JSON report, and (with ``--gate``) exits non-zero on any
finding."""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.analysis import report, run_all, write_report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static schedule-hazard verifier + registry contract "
                    "linter (no kernel launch).")
    parser.add_argument("--gate", action="store_true",
                        help="exit 1 if any finding is reported")
    parser.add_argument("--json", metavar="PATH",
                        help="write the structured findings report here")
    parser.add_argument("--device", default=None,
                        help="device whose routes and geometry are checked "
                             "(default: the card)")
    args = parser.parse_args(argv)

    t0 = time.perf_counter()
    findings, stats = run_all(args.device)
    stats["elapsed_s"] = round(time.perf_counter() - t0, 3)

    if args.json:
        rep = write_report(args.json, findings, stats)
    else:
        rep = report(findings, stats)

    print(f"repro_torch.analysis on {stats['device']}: "
          f"{stats['schedules_verified']} schedules verified across "
          f"{stats['routes']} routes / {stats['families']} families "
          f"(+{stats['sweep_schedules_verified']} at hand-made kernel "
          f"geometries); {stats['extensions_verified']} extension-state "
          f"proofs; {stats['files_scanned']} files linted "
          f"({stats['elapsed_s']}s)")
    if findings:
        print(f"FAIL: {len(findings)} finding(s):", file=sys.stderr)
        print(json.dumps(rep["counts"], indent=2, sort_keys=True),
              file=sys.stderr)
        for f in findings:
            probe = f" [{f.probe}]" if f.probe else ""
            print(f"  {f.check} · {f.subject}{probe}: {f.message}",
                  file=sys.stderr)
        return 1 if args.gate else 0
    print("OK: no findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
