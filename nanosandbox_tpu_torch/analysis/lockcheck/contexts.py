"""Thread-entrypoint index + lock-region tracking for lockcheck.

One :class:`ConcurrencyIndex` per module answers, purely syntactically,
the three questions every lockcheck rule needs:

  1. **Which execution context runs this function?** Entry points are
     classified from the idioms the serve stack actually uses —
     ``threading.Thread(target=f)`` / ``Thread`` subclass ``run``
     (context ``thread``), ``do_*`` methods of a
     ``BaseHTTPRequestHandler`` subclass (``handler``), ``async def``
     (``asyncio``), ``run_in_executor``/``Executor.submit`` targets
     (``executor``), ``threading.Timer`` callbacks (``timer``) — and
     propagated through the per-module call graph, so a helper called
     from a handler inherits ``handler``. Everything unreached is
     ``main``: the driving thread (bench loops, tests, module setup).
     Closures handed to a ``.call(...)`` marshal (the EngineLoop seam
     that runs ``fn(engine)`` ON the loop thread) classify as
     ``thread`` — the marshal is the blessed way to touch loop-owned
     state, and the index must not mistake it for the caller's context.

  2. **Which locks are held at each statement?** ``with self._lock:``
     regions tracked lexically, nested ``with`` accumulating in
     acquisition order. A lock is an attribute/name assigned
     ``threading.Lock/RLock/Condition/Semaphore`` in the module, or a
     ``with`` subject whose trailing name segment is lock-ish
     (``_lock``, ``_cond``, ``_mutex``); ids qualify by class
     (``EngineLoop._cond``) so the committed ordering file can name
     them.

  3. **Which attributes are declared guarded?** ``# guarded-by:
     <lock>`` trailing an attribute assignment declares its guarding
     lock; rules enforce every later access holds it.

Pure ast + tokenize: no torch, no imports of the analyzed code.
"""

from __future__ import annotations

import ast
import re
import tokenize
from dataclasses import dataclass, field
from io import StringIO
from typing import Dict, List, Optional, Set, Tuple

# The execution contexts the serve stack actually has: the
# engine stepping thread, stdlib HTTP handler threads, the asyncio
# router event loop, its executor pools, timer callbacks, and the main
# driving thread (bench/step loops, tests).
CONTEXTS = ("thread", "handler", "asyncio", "executor", "timer", "main")

_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_.]*)")

# `with self.X:` subjects whose trailing _-segment matches are treated
# as locks even without a visible threading.* assignment (a lock built
# by a base class or another module). "clock" does NOT match: the
# segment is "clock", not "lock".
_LOCKISH_SEGMENTS = {"lock", "rlock", "cond", "condition", "mutex",
                     "sem", "semaphore"}

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}

# Callables that run their function argument on another thread/loop.
# name -> (context, positional index of the callee argument or None
# for "target=" keyword).
_DISPATCHERS = {
    "run_in_executor": ("executor", 1),
    "submit": ("executor", 0),          # concurrent.futures Executor
    "call_soon": ("asyncio", 0),
    "call_soon_threadsafe": ("asyncio", 0),
    "call_later": ("asyncio", 1),
    "call": ("thread", 0),              # EngineLoop.call marshal seam
}


def _last_segment(name: str) -> str:
    return name.rsplit("_", 1)[-1].lower()


def _is_lockish_name(name: str) -> bool:
    return _last_segment(name) in _LOCKISH_SEGMENTS


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class LockSite:
    """One lock acquisition (a ``with`` entry)."""
    lock: str                      # qualified id, e.g. "EngineLoop._cond"
    line: int
    held: Tuple[str, ...]          # locks already held, outermost first


@dataclass
class AttrWrite:
    attr: str
    line: int
    held: Tuple[str, ...]
    in_init: bool


@dataclass
class AttrAccess:
    """Any ``self.attr`` use (read, write, or method call on it)."""
    attr: str
    line: int
    held: Tuple[str, ...]
    is_write: bool
    in_init: bool


@dataclass
class CallSite:
    callee: str                    # simple name
    line: int
    held: Tuple[str, ...]
    via_self: bool                 # spelled self.callee(...)
    awaited: bool = False
    in_lambda: bool = False


@dataclass
class RawAcquire:
    """An explicit ``X.acquire()`` call (not a ``with``)."""
    lock: str
    line: int
    released_in_finally: bool


@dataclass
class FunctionInfo:
    name: str
    qualname: str                  # "Class.method" or "fn" or "fn.<inner>"
    cls: Optional[str]
    node: ast.AST
    is_async: bool
    lineno: int
    entry: Set[str] = field(default_factory=set)
    contexts: Set[str] = field(default_factory=set)
    calls: List[CallSite] = field(default_factory=list)
    acquires: List[LockSite] = field(default_factory=list)
    raw_acquires: List[RawAcquire] = field(default_factory=list)
    writes: List[AttrWrite] = field(default_factory=list)
    accesses: List[AttrAccess] = field(default_factory=list)


class ConcurrencyIndex:
    """Per-module concurrency model: functions, contexts, lock regions,
    guarded-by declarations, and the acquired-while-holding graph."""

    def __init__(self, tree: ast.Module, source: str = ""):
        self.tree = tree
        self.functions: Dict[str, FunctionInfo] = {}   # by qualname
        self.by_name: Dict[str, List[FunctionInfo]] = {}
        self.class_bases: Dict[str, List[str]] = {}
        # class name (or "" for module level) -> set of lock attr names
        self.lock_attrs: Dict[str, Set[str]] = {}
        # (class, attr) -> declared guarding lock name
        self.guarded_by: Dict[Tuple[str, str], str] = {}
        # (context, target name) dispatch marks seen while analyzing —
        # applied AFTER collection, because the target def (e.g. a
        # nested `run` handed to threading.Thread) may not be collected
        # yet when its dispatcher is analyzed.
        self._pending_marks: List[Tuple[str, str]] = []
        self._guard_comments = self._parse_guard_comments(source)
        self._collect(tree)
        for ctx, name in self._pending_marks:
            for fi in self.by_name.get(name, []):
                fi.entry.add(ctx)
        self._classify_entries()
        self._propagate_contexts()

    # ------------------------------------------------------- collection
    @staticmethod
    def _parse_guard_comments(source: str) -> Dict[int, str]:
        """line -> lock name for every ``# guarded-by: X`` comment."""
        out: Dict[int, str] = {}
        if not source:
            return out
        try:
            toks = tokenize.generate_tokens(StringIO(source).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _GUARDED_BY_RE.search(tok.string)
                if m:
                    out[tok.start[0]] = m.group(1)
        except (tokenize.TokenError, IndentationError, SyntaxError):
            pass
        return out

    def _collect(self, tree: ast.Module) -> None:
        # First sweep: classes, bases, lock constructions, guarded-by.
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                bases = []
                for b in node.bases:
                    d = _dotted(b)
                    if d:
                        bases.append(d)
                self.class_bases[node.name] = bases
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call):
                ctor = _dotted(node.value.func) or ""
                if ctor.split(".")[-1] in _LOCK_CTORS and (
                        "threading" in ctor or "." not in ctor):
                    for tgt in node.targets:
                        if (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"):
                            cls = self._class_of(tree, node)
                            self.lock_attrs.setdefault(
                                cls or "", set()).add(tgt.attr)
                        elif isinstance(tgt, ast.Name):
                            self.lock_attrs.setdefault(
                                "", set()).add(tgt.id)
        # Guarded-by declarations: comment on a `self.attr = ...` line.
        for node in ast.walk(tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                lock = self._guard_comments.get(node.lineno)
                if lock is None:
                    continue
                targets = (node.targets
                           if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        cls = self._class_of(tree, node) or ""
                        self.guarded_by[(cls, tgt.attr)] = lock
        # Second sweep: functions (module level, methods, nested).
        self._walk_defs(tree.body, cls=None, prefix="")

    def _class_of(self, tree: ast.Module,
                  node: ast.AST) -> Optional[str]:
        # Cheap enclosing-class lookup by line span.
        best = None
        for cd in ast.walk(tree):
            if isinstance(cd, ast.ClassDef):
                end = getattr(cd, "end_lineno", cd.lineno)
                if cd.lineno <= node.lineno <= end:
                    if best is None or cd.lineno > best.lineno:
                        best = cd
        return best.name if best else None

    def _walk_defs(self, body, cls: Optional[str], prefix: str) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = (f"{cls}." if cls else "") + prefix + stmt.name
                info = FunctionInfo(
                    name=stmt.name, qualname=qual, cls=cls, node=stmt,
                    is_async=isinstance(stmt, ast.AsyncFunctionDef),
                    lineno=stmt.lineno)
                self.functions[qual] = info
                self.by_name.setdefault(stmt.name, []).append(info)
                self._analyze_function(info)
                self._walk_defs(stmt.body, cls=cls,
                                prefix=f"{prefix}{stmt.name}.")
            elif isinstance(stmt, ast.ClassDef):
                self._walk_defs(stmt.body, cls=stmt.name, prefix="")
            elif isinstance(stmt, (ast.If, ast.Try, ast.With,
                                   ast.AsyncWith, ast.For, ast.AsyncFor,
                                   ast.While)):
                # defs declared under a conditional/with/loop still
                # belong to this scope.
                for sub_body in (getattr(stmt, "body", []),
                                 getattr(stmt, "orelse", []),
                                 getattr(stmt, "finalbody", [])):
                    self._walk_defs(sub_body, cls=cls, prefix=prefix)
                for h in getattr(stmt, "handlers", []):
                    self._walk_defs(h.body, cls=cls, prefix=prefix)

    # -------------------------------------------- per-function analysis
    def lock_id(self, expr: ast.AST, cls: Optional[str]) -> Optional[str]:
        """Qualified lock id for a ``with`` subject / acquire receiver,
        or None when the expression is not lock-like."""
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            base = expr.value
            known = False
            if isinstance(base, ast.Name) and base.id == "self":
                known = attr in self.lock_attrs.get(cls or "", set())
                owner = cls or "self"
            else:
                owner = _dotted(base) or "*"
                known = any(attr in s for s in self.lock_attrs.values())
            if known or _is_lockish_name(attr):
                return f"{owner}.{attr}"
            return None
        if isinstance(expr, ast.Name):
            if (expr.id in self.lock_attrs.get("", set())
                    or _is_lockish_name(expr.id)):
                return expr.id
        return None

    def _analyze_function(self, info: FunctionInfo) -> None:
        in_init = info.name == "__init__"

        def scan_stmt(stmt: ast.stmt, held: Tuple[str, ...],
                      finally_releases: Tuple[frozenset, ...]) -> None:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return                      # nested defs analyzed separately
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                new_held = held
                for item in stmt.items:
                    lid = self.lock_id(item.context_expr, info.cls)
                    if lid is not None:
                        info.acquires.append(LockSite(
                            lock=lid, line=item.context_expr.lineno,
                            held=new_held))
                        new_held = new_held + (lid,)
                    else:
                        scan_expr(item.context_expr, held,
                                  finally_releases)
                for s in stmt.body:
                    scan_stmt(s, new_held, finally_releases)
                return
            if isinstance(stmt, ast.Try):
                released = set()
                for f in stmt.finalbody:
                    for node in ast.walk(f):
                        if (isinstance(node, ast.Call)
                                and isinstance(node.func, ast.Attribute)
                                and node.func.attr == "release"):
                            lid = self.lock_id(node.func.value, info.cls)
                            if lid:
                                released.add(lid)
                inner = finally_releases + (frozenset(released),)
                for s in stmt.body:
                    scan_stmt(s, held, inner)
                for h in stmt.handlers:
                    for s in h.body:
                        scan_stmt(s, held, inner)
                for s in stmt.orelse:
                    scan_stmt(s, held, inner)
                for s in stmt.finalbody:
                    scan_stmt(s, held, finally_releases)
                return
            if isinstance(stmt, (ast.If, ast.For, ast.AsyncFor,
                                 ast.While)):
                scan_expr(getattr(stmt, "test", None)
                          or getattr(stmt, "iter", None),
                          held, finally_releases)
                for s in list(stmt.body) + list(stmt.orelse):
                    scan_stmt(s, held, finally_releases)
                return
            # Plain statement: scan every expression in it.
            scan_expr(stmt, held, finally_releases)

        def scan_expr(node, held: Tuple[str, ...],
                      finally_releases: Tuple[frozenset, ...],
                      in_lambda: bool = False) -> None:
            # Recursive (not ast.walk): Await/Lambda must PRUNE so the
            # wrapped call is recorded exactly once, with its flag.
            if node is None:
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return
            if isinstance(node, ast.Lambda):
                # Lambda bodies run when (and where) the lambda is
                # called — mark their calls so context-sensitive rules
                # (asyncio-blocking-call) can skip executor thunks.
                scan_expr(node.body, held, finally_releases,
                          in_lambda=True)
                return
            if isinstance(node, ast.Await):
                if isinstance(node.value, ast.Call):
                    call = node.value
                    self._record_call(info, call, held, awaited=True,
                                      in_lambda=in_lambda,
                                      finally_releases=finally_releases)
                    for sub in (list(call.args)
                                + [kw.value for kw in call.keywords]):
                        scan_expr(sub, held, finally_releases, in_lambda)
                    scan_expr(call.func, held, finally_releases,
                              in_lambda)
                else:
                    scan_expr(node.value, held, finally_releases,
                              in_lambda)
                return
            if isinstance(node, ast.Call):
                self._record_call(info, node, held, in_lambda=in_lambda,
                                  finally_releases=finally_releases)
            if isinstance(node, (ast.Assign, ast.AugAssign,
                                 ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    attr = self._self_attr_target(tgt)
                    if attr is not None:
                        info.writes.append(AttrWrite(
                            attr=attr, line=node.lineno, held=held,
                            in_init=in_init))
            if isinstance(node, ast.Attribute) and isinstance(
                    node.value, ast.Name) and node.value.id == "self":
                is_store = isinstance(node.ctx, (ast.Store, ast.Del))
                info.accesses.append(AttrAccess(
                    attr=node.attr, line=node.lineno, held=held,
                    is_write=is_store, in_init=in_init))
            for child in ast.iter_child_nodes(node):
                scan_expr(child, held, finally_releases, in_lambda)

        for s in info.node.body:
            scan_stmt(s, (), ())

    @staticmethod
    def _self_attr_target(tgt: ast.AST) -> Optional[str]:
        """'attr' for self.attr / self.attr[k] assignment targets."""
        if isinstance(tgt, ast.Subscript):
            tgt = tgt.value
        if (isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"):
            return tgt.attr
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                a = ConcurrencyIndex._self_attr_target(e)
                if a is not None:
                    return a
        return None

    def _record_call(self, info: FunctionInfo, call: ast.Call,
                     held: Tuple[str, ...], *, in_lambda: bool = False,
                     awaited: bool = False,
                     finally_releases: Tuple[frozenset, ...] = ()
                     ) -> None:
        name = None
        via_self = False
        if isinstance(call.func, ast.Name):
            name = call.func.id
        elif isinstance(call.func, ast.Attribute):
            name = call.func.attr
            via_self = (isinstance(call.func.value, ast.Name)
                        and call.func.value.id == "self")
            if name == "acquire":
                lid = self.lock_id(call.func.value, info.cls)
                if lid is not None:
                    released = any(lid in s for s in finally_releases)
                    info.raw_acquires.append(RawAcquire(
                        lock=lid, line=call.lineno,
                        released_in_finally=released))
        if name is None:
            return
        info.calls.append(CallSite(callee=name, line=call.lineno,
                                   held=held, via_self=via_self,
                                   awaited=awaited, in_lambda=in_lambda))
        # Dispatcher idioms register their callee argument as an
        # entry point in another context.
        if name in _DISPATCHERS or name == "Thread" or name == "Timer":
            self._mark_dispatch(info, call, name)

    def _mark_dispatch(self, info: FunctionInfo, call: ast.Call,
                       name: str) -> None:
        def target_names(arg) -> List[str]:
            if isinstance(arg, ast.Name):
                return [arg.id]
            if isinstance(arg, ast.Attribute):
                return [arg.attr]
            if isinstance(arg, ast.Lambda):
                return []          # calls inside already marked in_lambda
            return []

        ctx = None
        cands: List[str] = []
        if name in ("Thread", "Timer"):
            ctx = "thread" if name == "Thread" else "timer"
            for kw in call.keywords:
                if kw.arg in ("target", "function"):
                    cands += target_names(kw.value)
            if name == "Timer" and len(call.args) >= 2:
                cands += target_names(call.args[1])
        else:
            ctx, pos = _DISPATCHERS[name]
            if len(call.args) > pos:
                cands += target_names(call.args[pos])
        for cand in cands:
            self._pending_marks.append((ctx, cand))

    # ---------------------------------------------------- classification
    def _bases_match(self, cls: str, needle: str) -> bool:
        for b in self.class_bases.get(cls, []):
            if needle in b:
                return True
        return False

    def _classify_entries(self) -> None:
        for info in self.functions.values():
            if info.is_async:
                info.entry.add("asyncio")
            if info.cls:
                if (info.name == "run"
                        and self._bases_match(info.cls, "Thread")):
                    info.entry.add("thread")
                if (info.name.startswith("do_")
                        and (self._bases_match(info.cls,
                                               "BaseHTTPRequestHandler")
                             or self._bases_match(info.cls,
                                                  "RequestHandler"))):
                    info.entry.add("handler")

    def _propagate_contexts(self) -> None:
        for info in self.functions.values():
            info.contexts = set(info.entry)
        changed = True
        while changed:
            changed = False
            for info in self.functions.values():
                src = info.contexts or {"main"}
                for call in info.calls:
                    for callee in self._resolve(info, call):
                        before = len(callee.contexts)
                        callee.contexts |= src
                        if len(callee.contexts) != before:
                            changed = True
        for info in self.functions.values():
            if not info.contexts:
                info.contexts = {"main"}

    def _resolve(self, caller: FunctionInfo,
                 call: CallSite) -> List[FunctionInfo]:
        cands = self.by_name.get(call.callee, [])
        if not cands:
            return []
        if call.via_self and caller.cls:
            same = [c for c in cands if c.cls == caller.cls]
            if same:
                return same
        return cands

    # ------------------------------------------------- derived relations
    def transitive_acquires(self) -> Dict[str, Set[str]]:
        """qualname -> every lock the function may acquire, including
        through same-module callees (fixpoint over the call graph)."""
        acq = {q: {a.lock for a in f.acquires}
               for q, f in self.functions.items()}
        changed = True
        while changed:
            changed = False
            for q, f in self.functions.items():
                for call in f.calls:
                    for callee in self._resolve(f, call):
                        extra = acq[callee.qualname] - acq[q]
                        if extra:
                            acq[q] |= extra
                            changed = True
        return acq

    def lock_edges(self) -> List[Tuple[str, str, str, int]]:
        """Acquired-while-holding edges: (held, acquired, file-qualname,
        line) — direct ``with`` nesting plus calls under a lock into
        functions that acquire."""
        edges: List[Tuple[str, str, str, int]] = []
        acq = self.transitive_acquires()
        for q, f in self.functions.items():
            for site in f.acquires:
                for h in site.held:
                    edges.append((h, site.lock, q, site.line))
            for call in f.calls:
                if not call.held:
                    continue
                for callee in self._resolve(f, call):
                    for lid in acq[callee.qualname]:
                        for h in call.held:
                            if h != lid:
                                edges.append((h, lid, q, call.line))
        return edges
