"""CLI: ``python -m repro_torch.analysis [paths...]``.

Runs the AST lint rules and the contract sweep over the port's tree.
Prints ``path:line:col: [rule] message`` findings (``--format`` switches
to GitHub annotations or SARIF) and exits non-zero if any finding is
neither pragma'd (``# analysis: ok=<rule>``) nor listed in the baseline
file (``src/repro_torch/analysis/baseline.txt``) with a justification.

The contracts run on ``--device`` (default: the CUDA card, where the
kernels launch; without a card that raises, as every entry point of the
port does).  ``--device cpu`` runs them on the CPU; ``--no-contracts``
needs no device.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.findings import RENDERERS, Baseline, filter_findings
from repro_torch.analysis.lint import all_rules, lint_paths

DEFAULT_PATHS = ("src/repro_torch",)
DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.txt"
_HEADER = ["# repro.analysis baseline — reviewed exceptions.",
           "# Format: path :: rule :: offending source line "
           ":: justification."]


def find_repo_root(start: Path) -> Path:
    for cand in [start] + list(start.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return start


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-specific static analysis of the port (lint + "
                    "contracts)")
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
        print(f"repro_torch.analysis: clean ({' + '.join(parts)})"
              if parts else "repro_torch.analysis: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
