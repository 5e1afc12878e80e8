"""Static analysis of the port's DP stack: the schedule gate. It launches
no kernel; on the card it asks only the occupancy API, as the launchers
do.

* :mod:`repro_torch.analysis.verifier` — the schedule-hazard verifier:
  proves write-before-read finalization for every registered family ×
  route on the family's probe instances (distance-vector margins +
  exhaustive symbolic simulation). The plain routes' schedules are the
  reference's; the kernel routes' describe the Hopper kernels
  (``repro_torch.kernels.schedule``) at the geometry their launchers take
  on the device, plus hand-made small geometries, with the kernels'
  geometry rules as invariants. ``verify_launches`` holds the geometry
  the kernel wrappers recorded at their launches against the
  descriptors'.
* :mod:`repro_torch.analysis.linter` — the registry contract linter: no
  knobs, the calibration platform key, calibration regime isolation,
  shape-key round-trips, capability pairs.
* :mod:`repro_torch.analysis.extension` — the extension-state sufficiency
  verifier: a reachability fixpoint proving each family's streaming
  resume state carries every prefix value its extension region's
  recurrence reads.

``python -m repro_torch.analysis --gate`` runs all three on the card (or
``--device cpu``) and fails on any finding: a new route registers a
``schedule=`` descriptor or the gate fails it.
"""
from repro_torch.analysis.extension import verify_extension, verify_extensions
from repro_torch.analysis.findings import Finding, report, write_report
from repro_torch.analysis.linter import run_linter
from repro_torch.analysis.verifier import (verify_launches, verify_registry,
                                           verify_schedule)

__all__ = ["Finding", "report", "run_all", "run_linter",
           "verify_extension", "verify_extensions", "verify_launches",
           "verify_registry", "verify_schedule", "write_report"]


def run_all(device=None, source_root=None):
    """Verifier + extension-sufficiency proofs + linter on ``device`` (the
    card by default); returns (findings, stats)."""
    findings, stats = verify_registry(device)
    ext_findings, ext_stats = verify_extensions()
    lint_findings, lint_stats = run_linter(device, source_root)
    return (findings + ext_findings + lint_findings,
            {**stats, **ext_stats, **lint_stats})
