"""Finding records + the structured JSON report of the static schedule gate.

Every analysis check emits :class:`Finding`s — one per violated property,
with enough structure for CI artifacts to be diffed and for tests to
assert on specific checks. Zero findings is the pass state the CI gate
requires.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List

__all__ = ["Finding", "report", "write_report"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated property.

    ``check`` is the rule id (e.g. ``read_before_finalize``,
    ``invariant_violated``, ``environment_read``); ``subject`` the
    route/module/kernel it is about; ``probe`` the probe-instance label when
    the rule ran against a concrete instance; ``detail`` free-form
    structured context (witness cells, steps, values)."""

    check: str
    subject: str
    message: str
    probe: str = ""
    detail: dict = dataclasses.field(default_factory=dict)


def report(findings: List[Finding], stats: dict) -> dict:
    """The JSON-serializable report: stable shape for CI artifacts."""
    by_check: dict = {}
    for f in findings:
        by_check[f.check] = by_check.get(f.check, 0) + 1
    return {
        "version": 1,
        "ok": not findings,
        "stats": dict(stats),
        "counts": by_check,
        "findings": [dataclasses.asdict(f) for f in findings],
    }


def write_report(path: str, findings: List[Finding], stats: dict) -> dict:
    rep = report(findings, stats)
    with open(path, "w") as fh:
        json.dump(rep, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return rep
