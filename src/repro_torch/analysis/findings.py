"""Finding records, inline pragmas and the reviewed baseline file.

The port's own copy of ``repro/analysis/findings.py``: every function
behaves as there, the pragma syntax and the baseline format included;
only the SARIF tool name is ``repro_torch.analysis``.

Shared by the AST lint engine (``analysis/lint.py``), the abstract-
interpretation contract checker (``analysis/contracts.py``) and the CLI
(``python -m repro_torch.analysis``).

Suppression has two layers, both reviewed in-tree:

- an **inline pragma** ``# analysis: ok=<rule>[,<rule>]`` on the offending
  line accepts that one site (``# analysis: ok`` with no rule list accepts
  every rule on the line) — use it where the exception is a documented
  contract of the surrounding code;
- the **baseline file** (``src/repro_torch/analysis/baseline.txt``)
  accepts findings by ``(path, rule, source-line)`` with a mandatory
  one-line justification — use it for exceptions that belong to review
  history rather than to the code itself.

Baseline entries key on the *stripped source text* of the offending line,
not its line number, so ordinary edits elsewhere in a file never stale the
baseline; editing the offending line itself re-surfaces the finding for
re-review, which is the point.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

PRAGMA_RE = re.compile(r"#\s*analysis:\s*ok(?:=(?P<rules>[\w,-]+))?")
_SEP = " :: "


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation at a source location (``path`` is repo-relative)."""
    path: str
    line: int
    col: int
    rule: str
    message: str
    snippet: str = ""    # stripped source of the offending line

    def key(self) -> Tuple[str, str, str]:
        return (self.path, self.rule, self.snippet)

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] " \
               f"{self.message}"


def pragma_rules(source_line: str):
    """Rules accepted by an inline pragma on ``source_line``.

    Returns ``None`` when there is no pragma, an empty frozenset for the
    blanket ``# analysis: ok``, else the frozenset of named rules."""
    mt = PRAGMA_RE.search(source_line)
    if mt is None:
        return None
    names = mt.group("rules")
    if not names:
        return frozenset()
    return frozenset(r.strip() for r in names.split(",") if r.strip())


def suppressed_by_pragma(finding: Finding, lines: Sequence[str]) -> bool:
    if not 1 <= finding.line <= len(lines):
        return False
    rules = pragma_rules(lines[finding.line - 1])
    if rules is None:
        return False
    return not rules or finding.rule in rules


class Baseline:
    """The reviewed exception list: ``path :: rule :: snippet :: why``."""

    def __init__(self, entries: Dict[Tuple[str, str, str], str] | None = None):
        self.entries = dict(entries or {})
        self.hits: set = set()

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        entries: Dict[Tuple[str, str, str], str] = {}
        if not path.exists():
            return cls(entries)
        for ln, raw in enumerate(path.read_text().splitlines(), 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(_SEP, 3)
            if len(parts) != 4:
                raise ValueError(
                    f"{path}:{ln}: baseline entries are "
                    f"'path :: rule :: snippet :: justification', "
                    f"got {raw!r}")
            fpath, rule, snippet, why = (p.strip() for p in parts)
            if not why:
                raise ValueError(
                    f"{path}:{ln}: baseline entry for {fpath} [{rule}] "
                    f"needs a one-line justification")
            entries[(fpath, rule, snippet)] = why
        return cls(entries)

    def covers(self, finding: Finding) -> bool:
        key = finding.key()
        if key in self.entries:
            self.hits.add(key)
            return True
        return False

    def stale(self) -> List[Tuple[str, str, str]]:
        """Entries that matched nothing this run (candidates for removal)."""
        return sorted(k for k in self.entries if k not in self.hits)

    @staticmethod
    def render(findings: Iterable[Finding],
               why: str = "TODO: one-line justification") -> str:
        lines = ["# repro.analysis baseline — reviewed exceptions.",
                 "# Format: path :: rule :: offending source line "
                 ":: justification."]
        for f in sorted(set(findings), key=lambda f: f.key()):
            lines.append(_SEP.join((f.path, f.rule, f.snippet, why)))
        return "\n".join(lines) + "\n"


def render_text(findings: Sequence[Finding]) -> str:
    return "\n".join(f.format() for f in findings)


def render_github(findings: Sequence[Finding]) -> str:
    """GitHub Actions workflow-command annotations (one per finding).

    Annotation messages are single-line by protocol; newlines are
    escaped the way Actions expects (%0A)."""
    out = []
    for f in findings:
        msg = f"[{f.rule}] {f.message}".replace("%", "%25") \
            .replace("\r", "%0D").replace("\n", "%0A")
        out.append(f"::error file={f.path},line={max(1, f.line)},"
                   f"col={max(1, f.col)}::{msg}")
    return "\n".join(out)


def render_sarif(findings: Sequence[Finding],
                 rule_descriptions: Dict[str, str] | None = None) -> str:
    """Minimal SARIF 2.1.0 document for code-scanning upload."""
    descriptions = rule_descriptions or {}
    rule_ids = sorted({f.rule for f in findings})
    doc = {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "repro_torch.analysis",
                "informationUri":
                    "https://example.invalid/repro-analysis",
                "rules": [
                    {"id": rid,
                     "shortDescription": {
                         "text": descriptions.get(rid, rid)}}
                    for rid in rule_ids],
            }},
            "results": [{
                "ruleId": f.rule,
                "level": "error",
                "message": {"text": f.message},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": max(1, f.line),
                               "startColumn": max(1, f.col)},
                }}],
            } for f in findings],
        }],
    }
    return json.dumps(doc, indent=2, sort_keys=True)


RENDERERS = {
    "text": render_text,
    "github": render_github,
    "sarif": render_sarif,
}


def filter_findings(findings: Iterable[Finding], baseline: Baseline,
                    sources: Dict[str, Sequence[str]]) -> List[Finding]:
    """Drop pragma- and baseline-suppressed findings.

    ``sources`` maps repo-relative paths to their source lines (for pragma
    lookup); contract findings have no source entry and only the baseline
    applies to them."""
    out = []
    for f in findings:
        lines = sources.get(f.path, ())
        if lines and suppressed_by_pragma(f, lines):
            continue
        if baseline.covers(f):
            continue
        out.append(f)
    return sorted(out, key=lambda f: (f.path, f.line, f.col, f.rule))
