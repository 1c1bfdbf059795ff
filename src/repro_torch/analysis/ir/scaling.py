"""K-scaling gate: fit per-buffer memory exponents in K and gate them
(``repro/analysis/ir/scaling.py``).

The engines are *designed* to be O(K) in memory on the user axis: stacked
user batches, codec snapshots, per-UAV channel traces — one row per user.
Anything super-linear (a K×K gram matrix from a badly-ordered einsum, a
broadcast that materializes) is exactly the class of bug that is
invisible at the test sizes (K=4) and fatal at fleet scale (K=256+).

``scaling_report`` traces every registry program at K ∈ ``K_VALUES``,
reuses the graph walker's per-site ``site_max_bytes``, and fits a
log-log least-squares exponent per source site plus one for the total
liveness peak.  ``run_scaling_gate`` then applies the declared budgets:

- sites in the port's engine, kernel and model modules (and program
  arguments, and ops with no frame of the repo: torch's own, minted on
  their behalf) are *declared* O(K) — the data model says one row per
  user;
- undeclared sites get a strict O(1) cap, so an undeclared buffer that
  grows with K at all is a finding, with the same ``path:line``
  provenance the walker gives every buffer.

The fitted report is committed as ``src/repro_torch/analysis/scaling.json``
(``--write-scaling`` regenerates it; the reference's
``analysis_scaling.json`` is XLA's and is not this record); the gate also
flags drift — a program whose total-peak exponent moved materially from
the committed record — so a regression shows up as a diff *and* a
finding.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.ir.graph_audit import (INTERNAL, ProgramAudit,
                                                 audit_program,
                                                 dtype_promotions,
                                                 trace_program)

K_VALUES: Tuple[int, ...] = (4, 16, 64, 256)
AUDIT_K = 4              # the graph audit's K (the first of the fit's)

# path-prefix -> declared exponent budget (first match wins).  The engine
# data model is one-row-per-user, so engine/kernel/model modules and the
# program arguments are declared O(K); ops with no frame of the repo
# inherit the same budget (they are minted on behalf of engine code).
DECLARED_BUDGETS: Tuple[Tuple[str, float], ...] = (
    ("<argument>", 1.0),
    (INTERNAL, 1.0),
    ("src/repro_torch/core/", 1.0),
    ("src/repro_torch/kernels/", 1.0),
    ("src/repro_torch/models/", 1.0),
    ("site-packages/", 1.0),
    ("/torch/", 1.0),
)
DEFAULT_CAP = 0.0        # undeclared sites: O(1) or it's a finding
TOLERANCE = 0.35         # fit slack: cap is budget + TOLERANCE
TOTAL_PEAK_CAP = 1.0     # the whole program must stay linear in K
DRIFT_TOLERANCE = 0.25   # vs the committed scaling record
_REPORT_SITES = 12       # top sites recorded per program (violators always)
RECORD = "src/repro_torch/analysis/scaling.json"


def declared_budget(path: str) -> Optional[float]:
    """The exponent budget for a source path, or None if undeclared."""
    for prefix, cap in DECLARED_BUDGETS:
        if path.startswith(prefix) or prefix in path:
            return cap
    return None


def fit_exponent(ks: Sequence[int], byts: Sequence[int]) -> Optional[float]:
    """Least-squares slope of log(bytes) against log(K).

    Returns None when the series can't be fit (a zero-byte point)."""
    pts = [(math.log(k), math.log(b)) for k, b in zip(ks, byts) if b > 0]
    if len(pts) < 2:
        return None
    xbar = sum(x for x, _ in pts) / len(pts)
    ybar = sum(y for _, y in pts) / len(pts)
    den = sum((x - xbar) ** 2 for x, _ in pts)
    if den == 0:
        return None
    return sum((x - xbar) * (y - ybar) for x, y in pts) / den


def _fit_program(prog, k_values: Sequence[int],
                 known: Optional[Dict[int, ProgramAudit]] = None
                 ) -> Dict[str, Any]:
    """Trace one program across K and fit every site + the total peak.
    ``known`` holds walks already made (the graph audit's at K = 4)."""
    per_k: Dict[int, ProgramAudit] = {}
    for k in k_values:
        per_k[k] = (known or {}).get(k) or audit_program(prog, k)
    sites = sorted({s for a in per_k.values() for s in a.site_max_bytes},
                   key=lambda s: (s.path, s.line, s.primitive))
    site_rows: List[Dict[str, Any]] = []
    for site in sites:
        byts = [per_k[k].site_max_bytes.get(site, 0) for k in k_values]
        exp = fit_exponent(k_values, byts)
        budget = declared_budget(site.path)
        site_rows.append({
            "site": site.label(),
            "path": site.path,
            "line": site.line,
            "bytes": {str(k): b for k, b in zip(k_values, byts)},
            "exponent": None if exp is None else round(exp, 3),
            "budget": budget,
            "declared": budget is not None,
        })
    totals = [per_k[k].peak_bytes for k in k_values]
    texp = fit_exponent(k_values, totals)
    return {
        "path": prog.path,
        "family": prog.family,
        "peak_bytes": {str(k): b for k, b in zip(k_values, totals)},
        "total_exponent": None if texp is None else round(texp, 3),
        "sites": site_rows,
    }


def _site_violations(row: Dict[str, Any]) -> Optional[str]:
    exp = row["exponent"]
    if exp is None:
        return None
    cap = (row["budget"] if row["declared"] else DEFAULT_CAP) + TOLERANCE
    if exp <= cap:
        return None
    biggest = max(int(b) for b in row["bytes"].values())
    if row["declared"]:
        return (f"buffer scales ~O(K^{exp:.2f}) but its module is declared "
                f"O(K^{row['budget']:.0f}) (cap {cap:.2f}; "
                f"largest {biggest / 1e6:.2f} MB)")
    return (f"undeclared buffer scales ~O(K^{exp:.2f}) in the user count "
            f"(cap {cap:.2f}; largest {biggest / 1e6:.2f} MB) — declare a "
            f"budget in analysis/ir/scaling.py or fix the allocation")


def _program_record(prog, k_values: Sequence[int],
                    known: Optional[Dict[int, ProgramAudit]] = None
                    ) -> Dict[str, Any]:
    """One program's committed record: the fit, every violating site and
    the top ``_REPORT_SITES`` others (the gate evaluates *all* sites
    before truncation); an ``error`` if a trace failed."""
    try:
        fitted = _fit_program(prog, k_values, known)
    except Exception as exc:
        return {"path": prog.path, "family": prog.family,
                "error": f"{type(exc).__name__}: {exc}"}
    for row in fitted["sites"]:
        msg = _site_violations(row)
        if msg:
            row["violation"] = msg
    keep = [r for r in fitted["sites"] if "violation" in r]
    rest = sorted((r for r in fitted["sites"] if "violation" not in r),
                  key=lambda r: -max(int(b) for b in r["bytes"].values()))
    fitted["sites"] = keep + rest[:_REPORT_SITES]
    fitted["sites_omitted"] = max(0, len(rest) - _REPORT_SITES)
    return fitted


def _empty_report(k_values: Sequence[int]) -> Dict[str, Any]:
    return {"k_values": list(k_values), "tolerance": TOLERANCE,
            "default_cap": DEFAULT_CAP, "programs": {}}


def scaling_report(programs=None, k_values: Sequence[int] = K_VALUES
                   ) -> Dict[str, Any]:
    """Fit exponents for every registry program; JSON-able."""
    return sweep(programs, k_values)[1]


# ---------------------------------------------------------------------------
# the whole sweep: graph audit + fits, in worker processes if asked
# ---------------------------------------------------------------------------

def _audit_at(prog, k: int):
    """One program at one K: ``(dtype findings, walk)`` — the dtype audit
    at ``AUDIT_K`` only — or ``(None, error)`` if the trace failed."""
    try:
        gm = trace_program(prog, k)
    except Exception as exc:      # a broken trace IS the finding
        return None, f"{type(exc).__name__}: {exc}"
    found = dtype_promotions(prog, gm=gm) if k == AUDIT_K else []
    return found, audit_program(prog, k, gm=gm)


def _audit_named(name: str, k: int, threads: int):
    import torch
    from repro_torch.analysis.ir.programs import engine_programs
    torch.set_num_threads(threads)
    prog = next((p for p in engine_programs() if p.name == name), None)
    if prog is None:
        raise KeyError(f"{name}: not in this process's engine_programs()")
    return _audit_at(prog, k)


def sweep(programs=None, k_values: Sequence[int] = K_VALUES, jobs: int = 1
          ) -> Tuple[List[Finding], Dict[str, Any]]:
    """The IR sweep: every program traced and walked at ``AUDIT_K`` and at
    each of ``k_values`` (once where they meet), its dtype audit at
    ``AUDIT_K`` (a failed trace there is an ``ir-trace`` finding), and
    its scaling record.  Returns the graph audit's findings and the
    report ``run_scaling_gate`` takes.

    With ``jobs`` > 1 the (program, K) walks run in that many spawned
    processes, each of which builds the registry anew and finds its
    programs there by name: they must be registry programs (a fixture,
    or a registry patched into this process, is swept with ``jobs`` =
    1)."""
    from repro_torch.analysis.ir.programs import engine_programs
    progs = list(programs if programs is not None else engine_programs())
    ks = [AUDIT_K] + [k for k in k_values if k != AUDIT_K]
    tasks = [(i, k) for i in range(len(progs)) for k in ks]
    if jobs > 1 and len(tasks) > 1:
        import multiprocessing
        import os
        from concurrent.futures import ProcessPoolExecutor
        jobs = min(jobs, len(tasks))
        threads = max(1, (os.cpu_count() or 1) // jobs)
        # the largest K and the device rounds are the longest: first
        order = sorted(tasks, key=lambda t: (-t[1], progs[t[0]].family
                                             != "device_round"))
        with ProcessPoolExecutor(
                jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
            futs = {t: ex.submit(_audit_named, progs[t[0]].name, t[1],
                                 threads) for t in order}
            done = {t: futs[t].result() for t in tasks}
    else:
        done = {(i, k): _audit_at(progs[i], k) for i, k in tasks}
    findings: List[Finding] = []
    report = _empty_report(k_values)
    for i, prog in enumerate(progs):
        found, first = done[(i, AUDIT_K)]
        if found is None:
            findings.append(Finding(
                prog.path, 1, 0, "ir-trace",
                f"{prog.name}: make_fx trace failed at K={AUDIT_K}: "
                f"{first}"))
        else:
            findings.extend(found)
        failed = next((walk for k in ks for found, walk in [done[(i, k)]]
                       if found is None), None)
        report["programs"][prog.name] = (
            {"path": prog.path, "family": prog.family, "error": failed}
            if failed is not None else _program_record(
                prog, k_values, {k: done[(i, k)][1] for k in ks}))
    return findings, report


def run_scaling_gate(programs=None, k_values: Sequence[int] = K_VALUES,
                     committed: Optional[Path] = None,
                     report: Optional[Dict[str, Any]] = None
                     ) -> Tuple[List[Finding], Dict[str, Any]]:
    """Apply the budgets (and drift vs the committed record) as findings."""
    if report is None:
        report = scaling_report(programs, k_values)
    findings: List[Finding] = []
    for name, rec in report["programs"].items():
        if "error" in rec:
            findings.append(Finding(
                rec["path"], 1, 0, "ir-scaling",
                f"{name}: scaling sweep failed: {rec['error']}"))
            continue
        for row in rec["sites"]:
            if "violation" in row:
                findings.append(Finding(
                    row["path"] if row["line"] else rec["path"],
                    row["line"] or 1, 0, "ir-scaling",
                    f"{name}: {row['site']}: {row['violation']}"))
        texp = rec["total_exponent"]
        if texp is not None and texp > TOTAL_PEAK_CAP + TOLERANCE:
            findings.append(Finding(
                rec["path"], 1, 0, "ir-scaling",
                f"{name}: total liveness peak scales ~O(K^{texp:.2f}) "
                f"(cap {TOTAL_PEAK_CAP + TOLERANCE:.2f}) — the program is "
                f"super-linear in the user count"))
    if committed is not None:
        findings.extend(_drift_findings(report, committed))
    return findings, report


def _drift_findings(report: Dict[str, Any],
                    committed_path: Path) -> List[Finding]:
    try:
        committed = json.loads(Path(committed_path).read_text())
    except FileNotFoundError:
        return [Finding(
            str(committed_path), 1, 0, "ir-scaling",
            "committed scaling record missing — run "
            "`python -m repro_torch.analysis --write-scaling` and commit "
            "it")]
    except Exception as exc:
        return [Finding(str(committed_path), 1, 0, "ir-scaling",
                        f"committed scaling record unreadable: {exc}")]
    out: List[Finding] = []
    old = committed.get("programs", {})
    for name, rec in report["programs"].items():
        texp, prev = rec.get("total_exponent"), old.get(name, {})
        pexp = prev.get("total_exponent")
        if texp is None or pexp is None:
            continue
        if abs(texp - pexp) > DRIFT_TOLERANCE:
            out.append(Finding(
                rec["path"], 1, 0, "ir-scaling",
                f"{name}: total-peak exponent drifted "
                f"{pexp:.2f} -> {texp:.2f} vs the committed scaling record "
                f"(tolerance {DRIFT_TOLERANCE}) — regenerate with "
                f"--write-scaling if intentional"))
    return out


def write_scaling_json(path: Path, report: Dict[str, Any]) -> None:
    Path(path).write_text(
        json.dumps(report, indent=2, sort_keys=True) + "\n")
