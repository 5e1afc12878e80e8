"""Extension-state sufficiency verifier.

The streaming subsystem's correctness hangs on one claim per family: the
resume payload (``Spec.extension_state`` — described cell-wise by
``saved_state_cells``) carries *every* prefix value the extension region's
recurrence will ever read. A family that saves too little produces tables
that are silently wrong only at larger sizes (the classic incremental-DP
bug: "the last few diagonals look sufficient" for triangular charts, but a
new cell ``(i, j)`` reads row entries across the *entire* prefix).

This verifier proves sufficiency symbolically, with no device execution,
by a reachability fixpoint over the family's ground-truth
:class:`~repro_torch.dp.schedule.DependencyModel`:

* **available** starts as the preset cells plus the prefix cells the
  family's saved state covers (``saved_state_cells`` mapped into the
  extended layout). Unsaved prefix cells are *never* recomputed by an
  extension solve, so they never become available.
* an extension cell (one outside ``prefix_cell_map``'s image) becomes
  computable — and available — once every operand of every candidate of
  its recurrence is available.
* iterate to fixpoint. Any extension cell left uncomputable is a proof of
  insufficiency, reported with a witness operand (an unsaved prefix cell
  the recurrence needs).

``saved_cells`` can be overridden to audit a *candidate* resume-state
design before implementing it (e.g. the known-undersized "trailing
diagonals" TriangularSpec state, which it rejects).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.analysis.findings import Finding
from repro_torch.dp.problem import Spec

__all__ = ["verify_extension", "verify_extensions"]

#: cap on reported witnesses per (spec, prefix) pair — one witness proves
#: insufficiency; thousands of repeats would drown the report
_MAX_WITNESSES = 4


def verify_extension(spec: Spec, prefix_len: int,
                     saved_cells: Optional[Iterable[int]] = None,
                     route: str = "") -> List[Finding]:
    """Prove the resume state for extending ``spec``'s length-
    ``prefix_len`` prefix is sufficient. Empty list = proven: every
    extension cell is computable from preset values, saved prefix state,
    and already-computed extension cells. ``saved_cells`` (extended-layout
    cell ids) overrides the family's ``saved_state_cells`` to audit an
    alternative design."""
    subject = route or f"{spec.family}:extend"
    out: List[Finding] = []
    dep = spec.schedule_model()

    def finding(check: str, message: str, **detail) -> None:
        out.append(Finding(check=check, subject=subject, message=message,
                           probe=f"{dep.label}@{prefix_len}", detail=detail))

    prefix = spec.split_spec(prefix_len)
    prefix_cells = frozenset(int(c) for c in
                             np.asarray(spec.prefix_cell_map(prefix)))
    if saved_cells is None:
        saved_cells = spec.saved_state_cells(prefix)
    saved = frozenset(int(c) for c in np.asarray(saved_cells))

    stray = sorted(saved - prefix_cells)
    if stray:
        finding("saved_state_outside_prefix",
                f"saved state claims {len(stray)} cell(s) the prefix "
                f"table does not cover (first: {stray[0]})",
                cells=stray[:_MAX_WITNESSES])
        return out

    ext_cells = [c for c in range(dep.cells) if c not in prefix_cells]
    available = set(dep.preset) | saved
    # preset extension cells (init boundary values) are available from
    # their initialization, like any cold solve's
    pending = [c for c in ext_cells if c not in available]

    # reachability fixpoint: each pass promotes every extension cell whose
    # full candidate set reads only available operands; terminates because
    # `available` only grows
    changed = True
    while changed and pending:
        changed = False
        still = []
        for c in pending:
            cands = dep.candidates[c]
            if cands and all(o in available
                             for cand in cands for o in cand):
                available.add(c)
                changed = True
            else:
                still.append(c)
        pending = still

    witnesses = 0
    for c in pending:
        cands = dep.candidates[c]
        if not cands:
            # no recurrence and not preset: a cold solve could not compute
            # it either — the family's dependency model is the problem,
            # not the resume state (the hazard verifier flags it)
            continue
        blocked = sorted({o for cand in cands for o in cand
                          if o not in available and o in prefix_cells
                          and o not in saved})
        if blocked:
            finding("insufficient_resume_state",
                    f"extension cell {c} reads prefix cell {blocked[0]} "
                    "which the saved resume state does not carry "
                    f"({len(blocked)} unsaved prefix operand(s) in total)",
                    cell=c, unsaved_operands=blocked[:_MAX_WITNESSES])
        else:
            finding("extension_cell_unreachable",
                    f"extension cell {c} never becomes computable from "
                    "preset + saved + extension cells (cyclic or missing "
                    "dependency)", cell=c)
        witnesses += 1
        if witnesses >= _MAX_WITNESSES:
            break
    return out


def verify_extensions() -> Tuple[List[Finding], dict]:
    """Run the sufficiency proof over every registered family's probe
    instances, at every legal prefix length. Families predating the
    streaming hooks are reported — a family without an extension contract
    cannot be served by sessions."""
    from repro_torch.dp.problem import FAMILIES

    hooks = ("extend_length", "min_prefix_len", "split_spec",
             "extension_state", "prefix_cell_map", "saved_state_cells",
             "stitch_extension", "prefix_digest_chain")
    findings: List[Finding] = []
    proofs = 0
    for fam in sorted(FAMILIES):
        cls = FAMILIES[fam]
        missing = [h for h in hooks if not hasattr(cls, h)]
        if missing:
            findings.append(Finding(
                check="family_missing_extension_hooks", subject=fam,
                message=f"family {fam!r} lacks the streaming extension "
                        f"hooks: {', '.join(missing)}"))
            continue
        for spec in cls.probe_specs():
            n = spec.extend_length()
            for prefix_len in range(spec.min_prefix_len(), n):
                findings.extend(verify_extension(spec, prefix_len))
                proofs += 1
    return findings, {"extensions_verified": proofs}
