"""torchlint framework: findings, suppressions, rule registry, reports.

Deliberately torch-free (pure ``ast`` + stdlib): the lint runs on a bare
Python, and importing torch just to read source would drag the whole
accelerator runtime into a linter. Rules get a ``ModuleContext``
(parsed tree + the hot-set index from hotscope.py) and yield
``Finding``s; this module owns everything around them — file walking,
``# torchlint: disable=<rule> -- <reason>`` suppression comments (the
reason is mandatory), and the text/JSON renderers the gate consumes.
"""

from __future__ import annotations

import ast
import json
import re
import tokenize
from dataclasses import dataclass, field
from io import StringIO
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

JSON_SCHEMA_VERSION = 1

# Syntax: `torchlint: disable=host-sync -- why this is
# deliberate` after a `#` (spelled without the leading hash here so the
# unused-suppression check doesn't see this very comment as one).
_SUPPRESS_RE = re.compile(
    r"#\s*torchlint:\s*disable=([A-Za-z0-9_,\- ]+?)\s*(?:--\s*(.*?))?\s*$")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    file: str
    line: int
    col: int
    rule: str
    message: str

    def key(self) -> Tuple:
        return (self.file, self.line, self.col, self.rule, self.message)


@dataclass
class Suppression:
    line: int               # line the comment sits on
    rules: Tuple[str, ...]  # rule ids; ("all",) disables every rule
    reason: str             # mandatory — empty means the disable is void
    standalone: bool        # comment-only line: applies to the NEXT stmt line
    used: bool = False

    def covers(self, rule: str) -> bool:
        return "all" in self.rules or rule in self.rules


@dataclass
class ModuleContext:
    """Everything a rule needs about one source file."""
    path: str
    source: str
    tree: ast.Module
    index: object            # hotscope.ModuleIndex (typed loosely: no cycle)
    lines: List[str] = field(default_factory=list)


class Rule:
    """Base class: subclasses set ``id``/``doc`` and implement check().

    Adding a rule = subclass + register().
    """

    id: str = ""
    doc: str = ""

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        raise NotImplementedError


_REGISTRY: Dict[str, Rule] = {}


def register(rule_cls: Callable[[], Rule]):
    """Class decorator: instantiate and add to the global rule registry."""
    rule = rule_cls()
    if not rule.id:
        raise ValueError(f"rule {rule_cls.__name__} has no id")
    if rule.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {rule.id!r}")
    _REGISTRY[rule.id] = rule
    return rule_cls


def all_rules() -> Dict[str, Rule]:
    _load_builtin_rules()
    return dict(_REGISTRY)


_BUILTINS_LOADED = False


def _load_builtin_rules() -> None:
    # Import for the @register side effect; deferred so `import
    # nanosandbox_tpu_torch.analysis.core` alone never half-registers.
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True
    from nanosandbox_tpu_torch.analysis import rules_sync  # noqa: F401


# ---------------------------------------------------------------- suppression

def parse_suppressions(source: str, pattern: re.Pattern = _SUPPRESS_RE
                       ) -> List[Suppression]:
    """Extract the disable comments ``pattern`` matches (torchlint's by
    default, lockcheck passes its own) via tokenize, not regex over raw
    lines: a disable inside a string literal must not suppress."""
    out: List[Suppression] = []
    try:
        tokens = list(tokenize.generate_tokens(StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = pattern.search(tok.string)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = (m.group(2) or "").strip()
        standalone = tok.line.strip().startswith("#")
        out.append(Suppression(line=tok.start[0], rules=rules,
                               reason=reason, standalone=standalone))
    return out


def _suppression_for(sup: List[Suppression], finding: Finding,
                     lines: List[str]) -> Optional[Suppression]:
    for s in sup:
        if not s.covers(finding.rule):
            continue
        # Same-line, or a standalone comment above with NOTHING but
        # comments/blank lines in between (stacked disables + prose are
        # fine; a code line in between would let the disable silently
        # swallow a later, unaudited violation on it).
        if s.line == finding.line:
            return s
        if s.standalone and s.line < finding.line:
            between = lines[s.line:finding.line - 1]
            if all(not ln.strip() or ln.lstrip().startswith("#")
                   for ln in between):
                return s
    return None


def select_rules(rules: Dict[str, Rule],
                 select: Optional[Sequence[str]]) -> Dict[str, Rule]:
    """The registry restricted to ``select`` (None: every rule);
    ValueError on an unknown id."""
    if not select:
        return rules
    unknown = sorted(set(select) - set(rules))
    if unknown:
        raise ValueError(f"unknown rule id(s): {', '.join(unknown)}; "
                         f"known: {', '.join(sorted(rules))}")
    return {k: v for k, v in rules.items() if k in select}


def settle(raw: Iterable[Finding], suppressions: List[Suppression],
           lines: List[str], path: str, rule_ids: Iterable[str], tag: str,
           select: Optional[Sequence[str]] = None,
           strict_suppressions: bool = False,
           ) -> Tuple[List[Finding], int]:
    """Apply one file's ``# <tag>: disable=`` comments to its raw
    findings: (findings left, suppressed count).

    A bare disable is void AND a finding (the tool's contract is that
    every deliberate violation carries its why); a typo'd rule id is a
    finding. A REASONED disable whose line no longer triggers any of its
    rules has rotted: it is recorded (``unused_suppressions`` in the
    report) and, under ``strict_suppressions``, a finding. Under
    ``select`` the rot check only judges suppressions naming selected
    rules (the others never got a chance to match), and ``disable=all``
    only under a full run."""
    findings: List[Finding] = []
    suppressed = 0
    for f in sorted(set(raw), key=lambda f: f.key()):
        s = _suppression_for(suppressions, f, lines)
        if s is None:
            findings.append(f)
        elif not s.reason:
            s.used = True
            findings.append(f)
        else:
            s.used = True
            suppressed += 1
    rule_ids = sorted(rule_ids)
    known = set(rule_ids) | {"all", "parse-error", "bad-suppression",
                             "unused-suppression"}
    for s in suppressions:
        if not s.reason:
            findings.append(Finding(
                path, s.line, 0, "bad-suppression",
                "suppression without a reason — write "
                f"'# {tag}: disable=<rule> -- <why this is deliberate>'"))
        for r in s.rules:
            if r not in known:
                findings.append(Finding(
                    path, s.line, 0, "bad-suppression",
                    f"unknown rule id {r!r} in suppression — known: "
                    f"{', '.join(rule_ids)}"))
        if (s.reason and not s.used
                and (select is None
                     or ("all" not in s.rules
                         and all(r in select for r in s.rules)))):
            _UNUSED_LOG.append({
                "file": path, "line": s.line,
                "rules": list(s.rules), "reason": s.reason})
            if strict_suppressions:
                findings.append(Finding(
                    path, s.line, 0, "unused-suppression",
                    f"suppression for {', '.join(s.rules)} no longer "
                    "matches any finding — the audited violation is "
                    "gone; delete the comment (reason was: "
                    f"{s.reason!r})"))
    return sorted(set(findings), key=lambda f: f.key()), suppressed


# settle appends here so a report can list unused suppressions without
# changing the (findings, suppressed) signature; single-threaded like the
# rest of the CLI.
_UNUSED_LOG: List[dict] = []


def drain_unused_suppressions() -> List[dict]:
    """Take (and clear) the unused-suppression records accumulated by
    analyze_source calls since the last drain."""
    out, _UNUSED_LOG[:] = list(_UNUSED_LOG), []
    return out


def parse_error(path: str, e: SyntaxError) -> Finding:
    return Finding(path, e.lineno or 1, e.offset or 0, "parse-error",
                   f"could not parse: {e.msg}")


# ------------------------------------------------------------------ analysis

def analyze_source(source: str, path: str = "<string>",
                   select: Optional[Sequence[str]] = None,
                   strict_suppressions: bool = False,
                   ) -> Tuple[List[Finding], int]:
    """Lint one source string. Returns (findings, suppressed_count).
    ``select`` restricts to a subset of rule ids; suppressions as
    ``settle`` applies them."""
    from nanosandbox_tpu_torch.analysis.hotscope import ModuleIndex

    rules = select_rules(all_rules(), select)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [parse_error(path, e)], 0
    ctx = ModuleContext(path=path, source=source, tree=tree,
                        index=ModuleIndex(tree), lines=source.splitlines())
    raw: List[Finding] = []
    for rule in rules.values():
        raw.extend(rule.check(ctx))
    return settle(raw, parse_suppressions(source), ctx.lines, path,
                  all_rules(), "torchlint", select, strict_suppressions)


def iter_python_files(paths: Sequence[str]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            files.append(path)
    # De-dup while preserving order (a file listed and inside a dir).
    seen = set()
    out = []
    for f in files:
        r = f.resolve()
        if r not in seen and "__pycache__" not in f.parts:
            seen.add(r)
            out.append(f)
    return out


def report(tool: str, paths: Sequence[str],
           analyze: Callable[[str, str], Tuple[List[Finding], int]]
           ) -> dict:
    """Run ``analyze(source, path)`` over the Python files under
    ``paths``; the report dict render_json dumps."""
    findings: List[Finding] = []
    suppressed = 0
    drain_unused_suppressions()
    files = iter_python_files(paths)
    for f in files:
        try:
            src = f.read_text(encoding="utf-8")
        except (OSError, UnicodeDecodeError) as e:
            findings.append(Finding(str(f), 1, 0, "parse-error",
                                    f"could not read: {e}"))
            continue
        fs, sup = analyze(src, str(f))
        findings.extend(fs)
        suppressed += sup
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {
        "version": JSON_SCHEMA_VERSION,
        "tool": tool,
        "findings": [vars(f) for f in findings],
        "unused_suppressions": drain_unused_suppressions(),
        "summary": {
            "files_scanned": len(files),
            "findings": len(findings),
            "suppressed": suppressed,
            "by_rule": dict(sorted(by_rule.items())),
        },
    }


def analyze_paths(paths: Sequence[str],
                  select: Optional[Sequence[str]] = None,
                  strict_suppressions: bool = False) -> dict:
    """Lint files/directories; returns the report dict render_json dumps."""
    return report("torchlint", paths, lambda src, path: analyze_source(
        src, path, select=select, strict_suppressions=strict_suppressions))


# ------------------------------------------------------------------- reports

def render_text(report: dict) -> str:
    lines = [f"{f['file']}:{f['line']}:{f['col']}: {f['rule']}: "
             f"{f['message']}" for f in report["findings"]]
    unused = report.get("unused_suppressions", [])
    lines.extend(
        f"{u['file']}:{u['line']}: note: unused suppression for "
        f"{', '.join(u['rules'])} (use --strict-suppressions to fail "
        "on these)" for u in unused)
    s = report["summary"]
    lines.append(f"{report.get('tool', 'torchlint')}: {s['findings']} "
                 f"finding(s) in {s['files_scanned']} file(s), "
                 f"{s['suppressed']} suppressed"
                 + (f", {len(unused)} unused suppression(s)" if unused
                    else ""))
    return "\n".join(lines)


def render_json(report: dict) -> str:
    return json.dumps(report, indent=2, sort_keys=False)
