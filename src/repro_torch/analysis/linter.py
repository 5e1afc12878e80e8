"""Registry contract linter (rules L1–L5).

Registry-wide consistency checks that launch no kernel:

* **L1 no knobs** — the port reads no environment: no token of an
  environment read (the ``os`` module's environment mapping, its ``get…``
  accessor) and no ``REPRO``-prefixed knob name appears in
  ``src/repro_torch/`` or ``chip_smoke.py``. Every choice the port makes it
  makes from its inputs or from what the card reports.
* **L2 platform key** — the calibration tables' platform key
  (``autotune.platform``) tells the CPU and the card apart, so timings of
  the plain versions never stand in for the kernels'.
* **L3 regime isolation** — amortized ``batch``, ``reconstruct`` and
  ``extend`` calibration observations never transfer onto plain
  single-solve keys (``shape_key_distance`` must refuse across regimes).
* **L4 shape-key contract** — family-tagged keys, ``from_shape_key``
  round-trips, and the phantom spec validates.
* **L5 capability pairs** — batch capabilities imply their single-instance
  pair (the routing layer falls back batch→single), fused implies
  arg-emitting, and specs that refuse ``supports_args()`` give a reason.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from repro_torch.analysis.findings import Finding

__all__ = ["run_linter", "check_no_knobs"]

#: an environment read or a knob name; written in pieces so that this
#: file's own text does not match it
_ENV_READ = re.compile(r"\bos\.environ\b|\bget" r"env\b|\bREPRO" r"_[A-Z]")


def _source_files(source_root: Optional[str]) -> List[Path]:
    """The port's sources and the smoke script, or every ``*.py`` under
    ``source_root``."""
    if source_root is not None:
        return sorted(Path(source_root).rglob("*.py"))
    import repro_torch

    package = Path(repro_torch.__file__).parent
    smoke = package.parents[1] / "chip_smoke.py"
    return sorted(package.rglob("*.py")) + ([smoke] if smoke.exists() else [])


# --- L1: no knobs -------------------------------------------------------------
def check_no_knobs(source_root: Optional[str] = None) -> Tuple[List[Finding], int]:
    findings: List[Finding] = []
    files = _source_files(source_root)
    for path in files:
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            hit = _ENV_READ.search(line)
            if hit:
                findings.append(Finding(
                    check="environment_read", subject=str(path),
                    message=f"{path}:{lineno} reads the environment or names "
                            f"a knob ({hit.group(0)!r}); the port takes no "
                            "knobs",
                    detail={"file": str(path), "line": lineno,
                            "source": line.strip()}))
    return findings, len(files)


# --- L2: platform key ---------------------------------------------------------
def check_platform_key(device: torch.device) -> List[Finding]:
    from repro_torch.dp import autotune

    findings: List[Finding] = []
    cpu = autotune.platform(torch.device("cpu"))
    if cpu != "cpu":
        findings.append(Finding(
            check="platform_key_conflates", subject="autotune.platform",
            message=f"the CPU's calibration key is {cpu!r}, not 'cpu'"))
    if device.type == "cuda":
        card = autotune.platform(device)
        if card in ("", cpu) or card != torch.cuda.get_device_name(device):
            findings.append(Finding(
                check="platform_key_conflates", subject="autotune.platform",
                message=f"the card's calibration key is {card!r} (CPU: {cpu!r}); "
                        "it must be the card's name"))
    return findings


# --- L3: calibration regime isolation ---------------------------------------
def check_regime_isolation() -> List[Finding]:
    from repro_torch.dp import backends
    from repro_torch.dp.problem import FAMILIES

    findings: List[Finding] = []
    for fam in sorted(FAMILIES):
        key = FAMILIES[fam].probe_specs()[0].shape_key()
        cases = [
            ("plain vs batch", key, key + ("batch",), None),
            ("batch vs reconstruct",
             key + ("batch",), key + ("reconstruct",), None),
            ("plain vs extend", key, key + ("extend",), None),
            ("batch vs extend", key + ("batch",), key + ("extend",), None),
            ("same regime, same shape",
             key + ("batch",), key + ("batch",), 0.0),
        ]
        for label, a, b, want in cases:
            got = backends.shape_key_distance(a, b)
            if got != want:
                findings.append(Finding(
                    check="regime_leak", subject=fam,
                    message=f"shape_key_distance [{label}] returned "
                            f"{got!r}, expected {want!r} — "
                            + ("incomparable regimes must never transfer"
                               if want is None else
                               "same-regime keys must stay comparable"),
                    detail={"case": label}))
        geo, regime = backends.split_shape_key(key + ("batch",))
        if geo != key or regime != "batch":
            findings.append(Finding(
                check="regime_leak", subject=fam,
                message="split_shape_key failed to strip the batch "
                        "regime marker"))
    return findings


# --- L4: shape-key contract --------------------------------------------------
def check_shape_key_contract() -> List[Finding]:
    from repro_torch.dp.problem import FAMILIES

    findings: List[Finding] = []
    for fam in sorted(FAMILIES):
        cls = FAMILIES[fam]
        for spec in cls.probe_specs():
            key = spec.shape_key()
            label = f"{fam} probe {key!r}"
            if not key or key[0] != cls.family:
                findings.append(Finding(
                    check="shape_key_untagged", subject=fam,
                    message=f"{label}: shape_key must lead with the "
                            f"family tag {cls.family!r}, got "
                            f"{key[0] if key else key!r}"))
                continue
            phantom = cls.from_shape_key(key)
            if phantom.shape_key() != key:
                findings.append(Finding(
                    check="shape_key_roundtrip", subject=fam,
                    message=f"{label}: from_shape_key produced a spec "
                            f"with key {phantom.shape_key()!r}"))
            try:
                phantom.validate()
            except Exception as e:  # noqa: BLE001 — report, don't crash
                findings.append(Finding(
                    check="phantom_spec_invalid", subject=fam,
                    message=f"{label}: the phantom spec fails validate(): "
                            f"{e}"))
    return findings


# --- L5: capability pairs ----------------------------------------------------
def check_capability_pairs() -> List[Finding]:
    from repro_torch.dp import backends
    from repro_torch.dp.problem import FAMILIES

    backends.ensure_registered()
    findings: List[Finding] = []
    for name in backends.names():
        b = backends.get(name)
        pairs = [("batch_run_with_args", "run_with_args"),
                 ("batch_run_fused", "batch_run_with_args")]
        for have, need in pairs:
            if getattr(b, have) is not None and getattr(b, need) is None:
                findings.append(Finding(
                    check="capability_pair_broken", subject=name,
                    message=f"backend {name!r} exposes {have} without "
                            f"{need}; the routing layer's batch→single "
                            "and fused→args fallbacks assume the pair"))
    for fam in sorted(FAMILIES):
        for spec in FAMILIES[fam].probe_specs():
            supported = spec.supports_args()
            if not isinstance(supported, bool):
                findings.append(Finding(
                    check="supports_args_contract", subject=fam,
                    message=f"supports_args() returned "
                            f"{type(supported).__name__}, expected bool"))
            elif not supported and not spec.args_unsupported_reason():
                findings.append(Finding(
                    check="supports_args_contract", subject=fam,
                    message="a spec refusing supports_args() must give "
                            "an args_unsupported_reason()"))
    return findings


def run_linter(device=None, source_root: Optional[str] = None
               ) -> Tuple[List[Finding], dict]:
    """All linter rules on ``device`` (the card by default); returns
    (findings, stats)."""
    from repro_torch.dp import backends

    device = backends.resolve_device(device)
    findings: List[Finding] = []
    env_findings, files_scanned = check_no_knobs(source_root)
    findings.extend(env_findings)
    findings.extend(check_platform_key(device))
    findings.extend(check_regime_isolation())
    findings.extend(check_shape_key_contract())
    findings.extend(check_capability_pairs())
    return findings, {"files_scanned": files_scanned}
