"""Runtime capture budgets and the deliberate-host-sync ledger.

The static half of the contract is ``nanosandbox_tpu_torch.analysis``
(the host-sync rule); this module is the runtime half. The port compiles
no XLA program, so what it guards is what costs a live request its
latency the same way: a CUDA graph capture, or a kernel library load
(``ops/_build.py``). Each capture site calls ``bump(kind)`` on the
owner's registry before it builds (a build that can fail calls
``check(kind)`` before and ``bump(kind)`` after it); past the kind's
budget, or at any time while the registry is frozen, they raise
``CompileBudgetExceeded`` and nothing is built.

    reg = TraceBudgetRegistry()
    reg.register("decode", 2)          # Engine.max_programs()
    reg.bump("decode")                 # before each capture
    reg.counts()                       # {"decode": 1}
    with reg.frozen():                 # after the warmup: a capture raises
        serve_forever()

``host_sync`` is the blessed wrapper for a DELIBERATE device->host
readback (the host-sync rule recognises it and does not flag the call):
it counts the sync under a name, waits for or reads ``value``, and lets
callers report how many syncs a window held (the trainer's
``profile_steps`` window and the engine's ``POST /profile`` do).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional


def _obs_counter(metric: str, help: str, name: str):
    """The ``{name=...}`` child of a process-global counter family: the
    obs-registry mirror of this module's ledgers."""
    from nanosandbox_tpu_torch.obs.registry import global_registry

    return global_registry().counter(metric, help,
                                     labelnames=("name",)).labels(name=name)


class CompileBudgetExceeded(RuntimeError):
    """A program kind was captured or loaded more often than its budget,
    or at all while the registry was frozen: some input left the closed
    set of shapes the budget promises."""


class _Budget:
    __slots__ = ("name", "max_traces", "traces")

    def __init__(self, name: str, max_traces: int):
        self.name = name
        self.max_traces = max_traces
        self.traces = 0


class TraceBudgetRegistry:
    """A family of named capture budgets (one per Engine, and the
    process-global one the kernel libraries count on). Thread-safe: the
    engine captures on its stepping thread while /stats reads counts on
    HTTP handler threads."""

    def __init__(self):
        self._budgets: Dict[str, _Budget] = {}
        self._lock = threading.Lock()
        self._frozen = False

    def register(self, name: str, max_traces: int) -> None:
        if max_traces < 0:
            raise ValueError(f"max_traces must be >= 0, got {max_traces}")
        with self._lock:
            b = self._budgets.get(name)
            if b is None:
                self._budgets[name] = _Budget(name, max_traces)
            else:
                b.max_traces = max_traces

    def _refuse(self, b: _Budget) -> None:
        """Raise if one more capture of ``b`` is not allowed (lock held)."""
        if self._frozen:
            raise CompileBudgetExceeded(
                f"capture of {b.name!r} (would be #{b.traces + 1}) "
                "inside a frozen registry: the program set was "
                "declared complete (post-warmup serving)")
        if b.traces + 1 > b.max_traces:
            raise CompileBudgetExceeded(
                f"{b.name!r} would be captured {b.traces + 1} times, "
                f"budget {b.max_traces}: a call-site input left the "
                "closed set (an unbucketed shape or a new variant), "
                "or the budget must grow with the program set")

    def check(self, name: str) -> None:
        """Raise as ``bump(name)`` would, and count nothing: for a build
        that can fail, which checks before it starts and bumps once it
        has succeeded, so that a failed build leaves no count behind."""
        with self._lock:
            self._refuse(self._budgets.setdefault(name, _Budget(name, 0)))

    def bump(self, name: str) -> int:
        """Record one capture of ``name``; raises on budget overflow or
        when frozen. A rejected capture does not count: the raise comes
        before anything is built, so counts() stays the real set."""
        with self._lock:
            b = self._budgets.setdefault(name, _Budget(name, 0))
            self._refuse(b)
            b.traces += 1
            n = b.traces
        _obs_counter("compile_traces_total",
                     "Accepted captures and kernel library loads, by "
                     "program name (every budget registry in the "
                     "process).", name).inc()
        return n

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {n: b.traces for n, b in self._budgets.items()}

    def budgets(self) -> Dict[str, int]:
        with self._lock:
            return {n: b.max_traces for n, b in self._budgets.items()}

    @contextmanager
    def frozen(self):
        """Inside this context ANY new capture raises: the post-warmup
        serving contract (every program exists once /healthz is green)."""
        with self._lock:
            prev, self._frozen = self._frozen, True
        try:
            yield self
        finally:
            with self._lock:
                self._frozen = prev


# The process-global registry: the kernel libraries (ops/_build.py) count
# their one load here.
_GLOBAL = TraceBudgetRegistry()


def global_registry() -> TraceBudgetRegistry:
    return _GLOBAL


# ------------------------------------------------------- host-sync ledger

_sync_lock = threading.Lock()
_sync_counts: Dict[str, int] = {}


def host_sync(name: str, value=None):
    """The BLESSED deliberate device->host sync: counts it under
    ``name``, then waits for or reads ``value``. A 0-d tensor comes back
    as a Python float, any other tensor as a host tensor (``.cpu()``); a
    CUDA Event or Stream is waited on (None returned); None is counted
    only (a sync the caller makes right after, or a readback on the CPU
    where there is nothing to wait for)."""
    with _sync_lock:
        _sync_counts[name] = _sync_counts.get(name, 0) + 1
    _obs_counter("host_syncs_total",
                 "Deliberate device->host readbacks through the blessed "
                 "tracecheck.host_sync wrapper, by ledger name.",
                 name).inc()
    if value is None:
        return None
    if hasattr(value, "cpu"):
        return float(value) if value.dim() == 0 else value.cpu()
    value.synchronize()
    return None


def sync_counts() -> Dict[str, int]:
    with _sync_lock:
        return dict(_sync_counts)


def sync_delta(mark: Dict[str, int]) -> Dict[str, int]:
    """Per-name ledger growth since ``mark`` (a prior ``sync_counts()``),
    positive entries only: what a profile window reports."""
    return {k: v - mark.get(k, 0) for k, v in sync_counts().items()
            if v - mark.get(k, 0) > 0}


def sync_count(name: Optional[str] = None) -> int:
    """Total recorded deliberate host syncs (or just ``name``'s)."""
    with _sync_lock:
        if name is not None:
            return _sync_counts.get(name, 0)
        return sum(_sync_counts.values())
