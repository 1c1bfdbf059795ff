"""CLI: ``python -m repro_torch.analysis [paths...]``.

Runs the AST lint rules and the contract sweep over the port's tree, and,
with ``--ir``, the IR auditors (the aten-graph liveness walk, the bf16
promotion audit and the K-scaling gate against the committed
``src/repro_torch/analysis/scaling.json``).  Prints ``path:line:col: [rule] message`` findings (``--format`` switches
to GitHub annotations or SARIF) and exits non-zero if any finding is
neither pragma'd (``# analysis: ok=<rule>``) nor listed in the baseline
file (``src/repro_torch/analysis/baseline.txt``) with a justification.

The contracts run on ``--device`` (default: the CUDA card, where the
kernels launch; without a card that raises, as every entry point of the
port does).  ``--device cpu`` runs them on the CPU; ``--no-contracts``
needs no device.  The IR sweep traces its programs on the CPU whatever
``--device`` says: it is the counterpart of the reference's
``interpret=True`` programs, every kernel wrapper running its plain twin
on CPU tensors (``analysis/ir/programs.py``), not a fallback from the
card.  ``--jobs`` spreads its programs over that many processes.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from repro_torch.analysis.findings import RENDERERS, Baseline, filter_findings
from repro_torch.analysis.lint import all_rules, lint_paths

DEFAULT_PATHS = ("src/repro_torch",)
DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.txt"
DEFAULT_SCALING = "src/repro_torch/analysis/scaling.json"

# program-level IR rules (no AST Rule object to describe them)
IR_RULE_DESCRIPTIONS = {
    "ir-trace": "engine program failed to trace to an aten graph",
    "ir-dtype": "f32 tensor minted from bf16 operands in a bf16 program",
    "ir-scaling": "buffer scales past its declared O(K) budget",
}
_HEADER = ["# repro.analysis baseline — reviewed exceptions.",
           "# Format: path :: rule :: offending source line "
           ":: justification."]


def find_repo_root(start: Path) -> Path:
    for cand in [start] + list(start.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return start


def default_jobs() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def run_ir(root: Path, scaling_file: str, jobs: int):
    """The IR sweep (graph walk + dtype audit + scaling gate), traced on
    the CPU.  Lazy imports: this pulls in every engine."""
    from repro_torch.analysis.ir import run_scaling_gate, sweep
    findings, report = sweep(jobs=jobs)
    gate, _ = run_scaling_gate(committed=root / scaling_file, report=report)
    return findings + gate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-specific static analysis of the port (lint + "
                    "contracts + IR audit)")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {DEFAULT_PATHS})")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: auto-detected)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file, relative to the root")
    ap.add_argument("--device", default=None,
                    help="device of the contract sweep (default: the CUDA "
                         "card; 'cpu' runs the plain twins)")
    ap.add_argument("--no-contracts", action="store_true",
                    help="skip the contract sweep (lint only, no device)")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the AST lint rules (contracts only)")
    ap.add_argument("--ir", action="store_true",
                    help="run the IR auditors (aten-graph walk, bf16 "
                         "promotion audit, K-scaling gate); their programs "
                         "are traced on the CPU whatever --device says, "
                         "every kernel wrapper running its plain twin, as "
                         "the reference traces its kernels with "
                         "interpret=True")
    ap.add_argument("--scaling-file", default=DEFAULT_SCALING,
                    help="committed scaling record, relative to the root")
    ap.add_argument("--write-scaling", action="store_true",
                    help="regenerate the committed scaling record and exit")
    ap.add_argument("--jobs", type=int, default=default_jobs(),
                    help="processes of the IR sweep (default: the CPU "
                         "count, at most 8)")
    ap.add_argument("--format", choices=sorted(RENDERERS), default="text",
                    help="finding output format (default: text)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="print a baseline covering the current findings")
    ap.add_argument("--prune-baseline", action="store_true",
                    help="rewrite the baseline file dropping entries that "
                         "matched nothing this run")
    ap.add_argument("--strict-baseline", action="store_true",
                    help="fail (exit 1) on stale baseline entries")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    root = args.root or find_repo_root(Path.cwd())
    paths = args.paths or list(DEFAULT_PATHS)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.name:15s} {rule.description}")
        for name, desc in sorted(IR_RULE_DESCRIPTIONS.items()):
            print(f"{name:15s} {desc} (--ir)")
        return 0

    if args.write_scaling:
        from repro_torch.analysis.ir import sweep, write_scaling_json
        out = root / args.scaling_file
        write_scaling_json(out, sweep(jobs=args.jobs)[1])
        print(f"wrote {out}")
        return 0

    device = None
    if not args.no_contracts:
        # the device rule first: no card and no --device is an error
        # before any work is done
        from repro_torch.device import resolve_device
        device = resolve_device(args.device)

    findings, sources = [], {}
    if not args.no_lint:
        findings, sources = lint_paths(root, paths)
    if not args.no_contracts:
        # imported lazily: the contract sweep imports every engine
        from repro_torch.analysis.contracts import run_contracts
        findings.extend(run_contracts(repo_root=root, device=device))
    if args.ir:
        findings.extend(run_ir(root, args.scaling_file, args.jobs))
        # IR findings carry real source sites; load those files so the
        # inline-pragma layer applies to them like any lint finding
        for f in findings:
            fpath = root / f.path
            if f.path not in sources and fpath.is_file():
                sources[f.path] = fpath.read_text().splitlines()

    baseline_path = root / args.baseline
    baseline = Baseline.load(baseline_path)
    live = filter_findings(findings, baseline, sources)

    if args.write_baseline:
        sys.stdout.write(Baseline.render(live))
        return 0

    stale = baseline.stale()
    if args.prune_baseline and stale:
        kept = [" :: ".join((*key, why))
                for key, why in baseline.entries.items()
                if key in baseline.hits]
        baseline_path.write_text("\n".join(_HEADER + kept) + "\n")
        print(f"pruned {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} from {args.baseline}",
              file=sys.stderr)
        stale = []

    rendered = RENDERERS[args.format](live)
    if rendered:
        print(rendered)
    for key in stale:
        print(f"note: stale baseline entry (matched nothing): "
              f"{' :: '.join(key)}", file=sys.stderr)
    if live:
        print(f"\n{len(live)} finding(s). Fix, pragma "
              f"(# analysis: ok=<rule>) or baseline with a justification "
              f"in {args.baseline}.", file=sys.stderr)
        return 1
    if stale and args.strict_baseline:
        print(f"{len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} — remove them or run "
              f"--prune-baseline.", file=sys.stderr)
        return 1
    if args.format == "text":
        parts = [] if args.no_lint else ["lint"]
        if not args.no_contracts:
            parts.append(f"contracts on {device}")
        if args.ir:
            parts.append("ir on cpu")
        print(f"repro_torch.analysis: clean ({' + '.join(parts)})"
              if parts else "repro_torch.analysis: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
