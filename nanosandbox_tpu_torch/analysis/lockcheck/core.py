"""lockcheck framework: registry, suppressions, lock order, reports.

Same shape as the host-sync framework (``analysis/core.py``) and reusing
its :class:`Finding`/:class:`Suppression` machinery, but a separate
tool: its own ``# lockcheck: disable=<rule> -- <why>`` comment tag, its
own rule registry, and one extra input — the committed lock-ordering
file (``analysis/lock_order.json``), the concurrency analogue of the
committed capture budgets. Pure ast + stdlib; no torch.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from nanosandbox_tpu_torch.analysis.core import (  # noqa: F401
    Finding, Suppression, drain_unused_suppressions, parse_error,
    render_json, render_text, report, select_rules, settle)
from nanosandbox_tpu_torch.analysis.core import \
    parse_suppressions as _parse_suppressions
from nanosandbox_tpu_torch.analysis.lockcheck.contexts import ConcurrencyIndex

JSON_SCHEMA_VERSION = 1

# Spelled without the leading hash so this comment is not itself a
# suppression: `lockcheck: disable=blocking-under-lock -- why`.
_SUPPRESS_RE = re.compile(
    r"#\s*lockcheck:\s*disable=([A-Za-z0-9_,\- ]+?)\s*(?:--\s*(.*?))?\s*$")

# The committed lock ordering, beside this package (the CLI also takes
# --lock-order=PATH).
DEFAULT_LOCK_ORDER = str(Path(__file__).resolve().parent.parent
                         / "lock_order.json")


@dataclass
class LockOrder:
    """The canonical acquisition order: tiers, earliest-first, and the
    qualified lock ids pinned to each tier. Acquiring a lock in an
    EARLIER tier while holding one from a LATER tier inverts the order;
    intra-tier nesting is allowed (it cannot deadlock against the
    committed order, and the inversion rule's cycle check still catches
    genuine intra-tier cycles)."""
    tiers: Tuple[str, ...] = ()
    locks: Dict[str, str] = field(default_factory=dict)  # lock id -> tier

    def tier_index(self, lock: str) -> Optional[int]:
        tier = self.locks.get(lock)
        if tier is None:
            return None
        try:
            return self.tiers.index(tier)
        except ValueError:
            return None


def load_lock_order(path: str) -> LockOrder:
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    tiers = tuple(data.get("order", ()))
    locks = dict(data.get("locks", {}))
    for lock, tier in locks.items():
        if tier not in tiers:
            raise ValueError(
                f"lock {lock!r} pinned to unknown tier {tier!r}; "
                f"order file declares {list(tiers)}")
    return LockOrder(tiers=tiers, locks=locks)


@dataclass
class ModuleContext:
    """Everything a lockcheck rule needs about one source file."""
    path: str
    source: str
    tree: ast.Module
    conc: ConcurrencyIndex
    lines: List[str] = field(default_factory=list)
    lock_order: Optional[LockOrder] = None


class Rule:
    """Base class: subclasses set ``id``/``doc`` and implement check()."""

    id: str = ""
    doc: str = ""

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        raise NotImplementedError


_REGISTRY: Dict[str, Rule] = {}


def register(rule_cls: Callable[[], Rule]):
    rule = rule_cls()
    if not rule.id:
        raise ValueError(f"rule {rule_cls.__name__} has no id")
    if rule.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {rule.id!r}")
    _REGISTRY[rule.id] = rule
    return rule_cls


_BUILTINS_LOADED = False


def all_rules() -> Dict[str, Rule]:
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        _BUILTINS_LOADED = True
        from nanosandbox_tpu_torch.analysis.lockcheck import rules  # noqa: F401
    return dict(_REGISTRY)


def parse_suppressions(source: str) -> List[Suppression]:
    """Extract ``# lockcheck: disable=...`` comments (a 'lockcheck:'
    inside a string literal must not suppress)."""
    return _parse_suppressions(source, _SUPPRESS_RE)


def analyze_source(source: str, path: str = "<string>",
                   select: Optional[Sequence[str]] = None,
                   strict_suppressions: bool = False,
                   lock_order: Optional[LockOrder] = None,
                   ) -> Tuple[List[Finding], int]:
    """Lint one source string. Returns (findings, suppressed_count).
    Suppression semantics are the host-sync rule's (core.settle), under
    the ``lockcheck:`` tag."""
    rules = select_rules(all_rules(), select)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [parse_error(path, e)], 0
    ctx = ModuleContext(path=path, source=source, tree=tree,
                        conc=ConcurrencyIndex(tree, source),
                        lines=source.splitlines(), lock_order=lock_order)
    raw: List[Finding] = []
    for rule in rules.values():
        raw.extend(rule.check(ctx))
    return settle(raw, parse_suppressions(source), ctx.lines, path,
                  all_rules(), "lockcheck", select, strict_suppressions)


def analyze_paths(paths: Sequence[str],
                  select: Optional[Sequence[str]] = None,
                  strict_suppressions: bool = False,
                  lock_order: Optional[LockOrder] = None) -> dict:
    """Lint files/directories; returns the report dict render_json dumps."""
    return report("lockcheck", paths, lambda src, path: analyze_source(
        src, path, select=select, strict_suppressions=strict_suppressions,
        lock_order=lock_order))
