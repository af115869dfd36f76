"""schedcheck — deterministic schedule-fuzz harness for the serve host.

The port's copy of the JAX package's schedcheck, the runtime half of
lockcheck (a static pass paired with a dynamic witness): where lockcheck
PROVES properties of the source, schedcheck tries to BREAK them on a
live object graph —

  * every engine/fleet/router lock is replaced by a seeded-preemption
    instrumented wrapper that (a) asserts the committed lock order of
    ``analysis/lock_order.json`` at every acquisition and (b) injects a
    tiny sleep with seeded probability right before acquiring, forcing
    the cross-thread interleavings a quiet CI box would never hit;
  * ``sys.setswitchinterval`` is dropped to microseconds for the fuzz
    window, so iterate-while-mutate races ("dictionary changed size
    during iteration") become reliably reproducible instead of
    one-in-a-million;
  * traffic threads pump concurrent submit/step/stats/drain/debug calls
    through Engine+EngineLoop, Fleet, PrefixAffinityRouter, and
    DisaggPair under many seeds, recording every violation and every
    crashed thread as data (``Violation``), never as a test-framework
    accident.

Violations collected: ``order`` (acquired an earlier-tier lock while
holding a later-tier one), ``crash`` (a traffic thread died — the
dynamic signature of an unguarded shared structure). ``assert_clean()``
raises with the full list. The instrumentation is pure host Python:
zero new CUDA graph captures, zero new audited host syncs (pinned by
test against program_counts/max_programs and the sync ledger). Engines
capture their graphs in their constructors, so the wrappers go in after
every capture has closed, and an instrumented engine on the card
replays the same graphs.

CLI smoke: ``python -m nanosandbox_tpu_torch.utils.schedcheck
--target=router --seeds=20`` (the router target needs no torch;
``engine`` builds a tiny CPU model).
"""

from __future__ import annotations

import contextlib
import json
import random
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

DEFAULT_LOCK_ORDER = str(Path(__file__).resolve().parent.parent
                         / "analysis" / "lock_order.json")


def load_order(path: str = DEFAULT_LOCK_ORDER) -> Dict[str, int]:
    """lock name -> tier index from the committed ordering file (the
    same file lockcheck's lock-order-inversion rule enforces)."""
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    tiers = list(data.get("order", ()))
    return {lock: tiers.index(tier)
            for lock, tier in data.get("locks", {}).items()}


@dataclass
class Violation:
    kind: str        # "order" | "crash"
    detail: str
    thread: str
    seed: int


@dataclass
class SchedCheck:
    """One fuzz run's state: seeded preemption, per-thread held-lock
    stacks, order assertions, violation collection."""
    seed: int = 0
    order: Dict[str, int] = field(default_factory=dict)
    preempt_p: float = 0.05
    max_preempt_s: float = 0.0005

    def __post_init__(self):
        self._tls = threading.local()
        # Meta-lock for the shared violation list and counters — a
        # plain stdlib lock on purpose: the harness must not instrument
        # (and thereby fuzz) its own bookkeeping.
        self._meta = threading.Lock()
        self.violations: List[Violation] = []
        self.preemptions = 0
        self.acquires = 0

    # ------------------------------------------------------- thread state
    def _held(self) -> List[str]:
        if not hasattr(self._tls, "held"):
            self._tls.held = []
        return self._tls.held

    def _rng(self) -> random.Random:
        if not hasattr(self._tls, "rng"):
            # Deterministic per-thread stream: same seed + same thread
            # name -> same preemption schedule.
            name = threading.current_thread().name
            self._tls.rng = random.Random(f"{self.seed}:{name}")
        return self._tls.rng

    # ---------------------------------------------------------- recording
    def record(self, kind: str, detail: str) -> None:
        with self._meta:
            self.violations.append(Violation(
                kind=kind, detail=detail,
                thread=threading.current_thread().name, seed=self.seed))

    def note_acquire(self, name: str) -> None:
        """Called by instrumented locks right before acquiring: seeded
        preemption + committed-order assertion."""
        rng = self._rng()
        if rng.random() < self.preempt_p:
            with self._meta:
                self.preemptions += 1
            time.sleep(rng.random() * self.max_preempt_s)
        held = self._held()
        with self._meta:
            self.acquires += 1
        tier = self.order.get(name)
        if tier is None:
            return
        for h in held:
            if h == name:        # RLock re-entry: same lock, no edge
                continue
            ht = self.order.get(h)
            if ht is not None and ht > tier:
                self.record(
                    "order",
                    f"acquiring '{name}' (tier {tier}) while holding "
                    f"'{h}' (tier {ht}) — inverts the committed order")

    def push(self, name: str) -> None:
        self._held().append(name)

    def pop(self, name: str) -> None:
        held = self._held()
        if name in held:
            # Remove the most recent entry (RLock re-entries stack).
            for i in range(len(held) - 1, -1, -1):
                if held[i] == name:
                    del held[i]
                    break

    # ------------------------------------------------------------ results
    def assert_clean(self) -> None:
        if self.violations:
            lines = [f"  [{v.kind}] {v.thread} (seed {v.seed}): "
                     f"{v.detail}" for v in self.violations]
            raise AssertionError(
                f"schedcheck: {len(self.violations)} violation(s):\n"
                + "\n".join(lines))


class _InstrumentedLock:
    """Wraps a Lock/RLock/Condition: order-asserts + seeded-preempts on
    every acquisition, delegates everything else (wait/notify/...) to
    the wrapped object — EngineLoop's Condition keeps its semantics."""

    def __init__(self, inner, name: str, check: SchedCheck):
        self._inner = inner
        self._name = name
        self._check = check

    def acquire(self, *a, **kw):
        self._check.note_acquire(self._name)
        got = self._inner.acquire(*a, **kw)
        if got:
            self._check.push(self._name)
        return got

    def release(self):
        self._inner.release()
        self._check.pop(self._name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, attr):
        # Condition.wait releases + reacquires the UNDERLYING lock
        # internally; the held stack keeps the entry, which is correct:
        # order-wise the thread still "owns" the region.
        return getattr(self._inner, attr)


def wrap_lock(owner, attr: str, name: str, check: SchedCheck) -> None:
    """Replace ``owner.attr`` with an instrumented wrapper (idempotent:
    re-wrapping an already-instrumented lock is a no-op; a missing
    attribute is skipped so the fuzz loops still run against objects
    that lost a lock — which is exactly the regression they exist to
    crash on)."""
    inner = getattr(owner, attr, None)
    if inner is None:
        return
    if isinstance(inner, _InstrumentedLock):
        # Re-instrumenting (a fixture reused across seeds): keep the
        # wrapper, point it at this run's collector.
        inner._check = check
        return
    setattr(owner, attr, _InstrumentedLock(inner, name, check))


# --------------------------------------------------------- instrumenters

def instrument_router(router, check: SchedCheck) -> None:
    wrap_lock(router, "_lock", "PrefixAffinityRouter._lock", check)


def instrument_engine(engine, check: SchedCheck) -> None:
    wrap_lock(engine, "_profile_lock", "Engine._profile_lock", check)
    wrap_lock(engine.flight, "_lock", "FlightRecorder._lock", check)
    wrap_lock(engine.tracer, "_lock", "SpanTracer._lock", check)
    wrap_lock(engine.tracecheck, "_lock", "TraceBudgetRegistry._lock",
              check)


def instrument_engine_loop(loop, check: SchedCheck) -> None:
    wrap_lock(loop, "_cond", "EngineLoop._cond", check)
    instrument_engine(loop.engine, check)


def instrument_fleet(fleet, check: SchedCheck) -> None:
    instrument_router(fleet.router, check)
    wrap_lock(fleet.flight, "_lock", "FlightRecorder._lock", check)
    for eng in fleet.replicas.values():
        instrument_engine(eng, check)


def instrument_disagg(pair, check: SchedCheck) -> None:
    wrap_lock(pair.flight, "_lock", "FlightRecorder._lock", check)
    for eng in (pair.prefill, pair.decode):
        instrument_engine(eng, check)


@contextlib.contextmanager
def tight_switch_interval(interval: float = 5e-6):
    """Shrink the GIL switch interval for the fuzz window so structural
    races (iterate vs. mutate) surface reliably, then restore it."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(interval)
    try:
        yield
    finally:
        sys.setswitchinterval(prev)


# ------------------------------------------------------------- fuzz loops

def _run_threads(check: SchedCheck,
                 targets: Sequence[Tuple[str, Callable[[], None]]],
                 join_timeout: float = 60.0) -> None:
    """Run the traffic callables concurrently; any exception in any
    thread becomes a ``crash`` violation on ``check``."""

    def guard(name, fn):
        def run():
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — ALL crashes are data
                check.record("crash", f"{type(e).__name__}: {e}")
        return threading.Thread(target=run, name=name, daemon=True)

    threads = [guard(name, fn) for name, fn in targets]
    with tight_switch_interval():
        for t in threads:
            t.start()
        for t in threads:
            t.join(join_timeout)
            if t.is_alive():
                check.record("crash", f"thread {t.name} failed to "
                                      f"finish within {join_timeout}s")


def fuzz_router(seed: int, *, n_replicas: int = 4, iters: int = 300,
                order: Optional[Dict[str, int]] = None) -> SchedCheck:
    """Concurrent route/update/flap/stats traffic through one
    PrefixAffinityRouter — the pure-host target, no torch. Unlocked,
    the JAX package's router crashed with 'dictionary changed size
    during iteration' within a handful of seeds."""
    from nanosandbox_tpu_torch.serve.router import (NoReadyReplicaError,
                                              PrefixAffinityRouter)

    check = SchedCheck(seed=seed, order=order if order is not None
                       else _try_order())
    names = [f"r{i}" for i in range(n_replicas)]
    router = PrefixAffinityRouter(names, page=16)
    instrument_router(router, check)
    chains = [[f"d{g}-{j}" for j in range(1 + g % 4)] for g in range(8)]
    for name in names:
        router.update_replica(name, ready=True)

    def route_loop():
        r = random.Random(seed + 1)
        for i in range(iters):
            try:
                router.route(chains[r.randrange(len(chains))],
                             failover=(i % 17 == 0))
            except NoReadyReplicaError:
                pass          # flapper may have emptied the ready set
            router.match_tokens(names[i % n_replicas],
                                chains[i % len(chains)])

    def update_loop():
        r = random.Random(seed + 2)
        for i in range(iters):
            name = names[r.randrange(n_replicas)]
            router.update_replica(
                name, ready=(r.random() > 0.1),
                queued=r.randrange(8), active=r.randrange(4),
                brownout=r.randrange(3))
            router.observe_digests(name,
                                   chains[r.randrange(len(chains))])

    def refresh_loop():
        r = random.Random(seed + 3)
        for i in range(iters):
            name = names[r.randrange(n_replicas)]
            router.refresh_summary(
                name, chains[r.randrange(len(chains))])
            if i % 13 == 0:
                router.forget(name)

    def flap_loop():
        r = random.Random(seed + 4)
        for i in range(iters):
            extra = f"extra{r.randrange(3)}"
            if r.random() < 0.5:
                router.add_replica(extra)
                router.update_replica(extra, ready=True)
            else:
                router.remove_replica(extra)

    def stats_loop():
        for _ in range(iters):
            router.stats()
            router.ready_replicas()

    _run_threads(check, [("route", route_loop), ("update", update_loop),
                         ("refresh", refresh_loop), ("flap", flap_loop),
                         ("stats", stats_loop)])
    return check


def fuzz_engine_loop(loop, seed: int, *, n_requests: int = 4,
                     budget: int = 3, vocab: int = 50,
                     order: Optional[Dict[str, int]] = None,
                     reader_iters: int = 60,
                     requests: Optional[List[Tuple[List[int], dict]]]
                     = None) -> SchedCheck:
    """Concurrent submit + debug-view + stats traffic through a RUNNING
    EngineLoop (caller owns loop.start()/loop.stop()): the handler-
    thread traffic pattern, with prefix_summary marshalled through
    loop.call exactly as the HTTP handler now does. ``requests``, (prompt,
    submit keywords) pairs, when given, replace the n_requests seeded
    prompts over ``vocab``."""
    check = SchedCheck(seed=seed, order=order if order is not None
                       else _try_order())
    instrument_engine_loop(loop, check)
    rng = random.Random(seed)
    if requests is None:
        requests = [([rng.randrange(vocab) for _ in range(4 + 3 * i)], {})
                    for i in range(n_requests)]

    def submit_loop():
        pending = [loop.submit(prompt=p, max_new_tokens=budget, **kw)
                   for p, kw in requests]
        for p in pending:
            if not p.done.wait(60):
                raise TimeoutError("request did not finish under fuzz")
            if p.error is not None:
                raise p.error

    def debug_loop():
        eng = loop.engine
        for i in range(reader_iters):
            loop.stats()
            eng.stats()
            eng.debug_slots()
            eng.debug_scheduler()
            eng.debug_kvpool()
            if i % 5 == 0:
                try:
                    loop.call(lambda e: e.prefix_summary(), timeout=30)
                except RuntimeError:
                    pass      # loop already stopped at tail of fuzz

    def flight_loop():
        for _ in range(reader_iters):
            loop.engine.flight.events()
            loop.engine.flight.counts()
            loop.engine.tracer.export_chrome()

    _run_threads(check, [("submit", submit_loop),
                         ("debug", debug_loop),
                         ("flight", flight_loop)], join_timeout=120.0)
    return check


def fuzz_fleet(fleet, seed: int, *, n_requests: int = 4, budget: int = 3,
               vocab: int = 50,
               order: Optional[Dict[str, int]] = None,
               reader_iters: int = 80,
               requests: Optional[List[Tuple[List[int], dict]]] = None
               ) -> SchedCheck:
    """One stepping thread (the fleet's single-threaded contract) vs.
    concurrent stats/merged-ledger/router readers. ``requests``,
    (prompt, submit keywords) pairs, when given, replace the n_requests
    seeded prompts over ``vocab``."""
    check = SchedCheck(seed=seed, order=order if order is not None
                       else _try_order())
    instrument_fleet(fleet, check)
    rng = random.Random(seed)
    if requests is None:
        shared = [rng.randrange(vocab) for _ in range(18)]
        requests = [(shared + [rng.randrange(vocab) for _ in range(1 + i)]
                     if i % 2 == 0
                     else [rng.randrange(vocab) for _ in range(5 + 2 * i)],
                     {}) for i in range(n_requests)]

    def step_loop():
        for p, kw in requests:
            fleet.submit(p, budget, **kw)
        while fleet.has_work():
            fleet.step()

    def stats_loop():
        for _ in range(reader_iters):
            fleet.stats()
            fleet.retry_after_s()
            fleet.router.stats()

    def ledger_loop():
        for _ in range(reader_iters):
            fleet.merged_flight_events()

    _run_threads(check, [("step", step_loop), ("stats", stats_loop),
                         ("ledger", ledger_loop)], join_timeout=120.0)
    return check


def fuzz_disagg(pair, seed: int, *, n_requests: int = 4, budget: int = 3,
                vocab: int = 50,
                order: Optional[Dict[str, int]] = None,
                reader_iters: int = 80,
                requests: Optional[List[Tuple[List[int], dict]]] = None
                ) -> SchedCheck:
    """One migration-pump stepping thread vs. concurrent stats and
    merged-ledger readers on a DisaggPair. ``requests``, (prompt, submit
    keywords) pairs, when given, replace the n_requests seeded prompts
    over ``vocab``."""
    check = SchedCheck(seed=seed, order=order if order is not None
                       else _try_order())
    instrument_disagg(pair, check)
    rng = random.Random(seed)
    if requests is None:
        requests = [([rng.randrange(vocab) for _ in range(5 + 3 * i)], {})
                    for i in range(n_requests)]

    def step_loop():
        for i, (p, kw) in enumerate(requests):
            pair.submit(p, budget, **{"temperature": 0.0, "seed": seed + i,
                                      **kw})
        while pair.has_work():
            pair.step()

    def stats_loop():
        for _ in range(reader_iters):
            pair.stats()
            pair.retry_after_s()

    def ledger_loop():
        for _ in range(reader_iters):
            pair.merged_flight_events()

    _run_threads(check, [("step", step_loop), ("stats", stats_loop),
                         ("ledger", ledger_loop)], join_timeout=120.0)
    return check


def _try_order() -> Dict[str, int]:
    try:
        return load_order()
    except (OSError, ValueError):
        return {}


# -------------------------------------------------------------------- CLI

def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m nanosandbox_tpu_torch.utils.schedcheck",
        description="Seeded schedule-fuzz smoke over the serve host "
                    "locks (runtime half of lockcheck).")
    ap.add_argument("--target", choices=("router", "engine"),
                    default="router",
                    help="router = PrefixAffinityRouter fuzz (no "
                         "torch, no device); engine = EngineLoop fuzz over "
                         "a tiny seeded model on --device")
    ap.add_argument("--device", default="auto",
                    help="the engine target's device: auto (the GPU; "
                         "raises without one) | cuda | cpu")
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--lock-order", default=None, metavar="FILE")
    args = ap.parse_args(argv)

    order = (load_order(args.lock_order) if args.lock_order
             else _try_order())
    loop = _tiny_loop(args.device) if args.target == "engine" else None
    bad = 0
    total_pre = 0
    try:
        for seed in range(args.seeds):
            if args.target == "router":
                check = fuzz_router(seed, order=order)
            else:
                check = fuzz_engine_loop(loop, seed, order=order)
            total_pre += check.preemptions
            if check.violations:
                bad += 1
                for v in check.violations:
                    print(f"seed {seed}: [{v.kind}] {v.thread}: "
                          f"{v.detail}", file=sys.stderr)
    finally:
        if loop is not None:
            loop.stop()
            loop.join(30)
    print(f"schedcheck: {args.seeds} seed(s), target={args.target}, "
          f"{total_pre} preemption(s) injected, "
          f"{bad} seed(s) with violations")
    return 1 if bad else 0


def _tiny_loop(device: str = "auto"):
    """One started EngineLoop over a 2-layer model with seeded random
    weights on ``device`` (config.resolve_device: the GPU unless 'cpu'),
    shared across every CLI seed (the fuzz re-instruments the same locks
    per seed). Head size 32, the smallest the decode kernels take."""
    import torch

    from nanosandbox_tpu_torch.config import GPTConfig, resolve_device
    from nanosandbox_tpu_torch.models.gpt import GPT
    from nanosandbox_tpu_torch.serve.engine import Engine
    from nanosandbox_tpu_torch.serve.http import EngineLoop

    dev = resolve_device(device)
    cfg = GPTConfig(n_layer=2, n_head=2, n_embd=64, block_size=64,
                    vocab_size=50, dropout=0.0, compute_dtype="float32")
    model = GPT(cfg, device=dev,
                generator=torch.Generator(device=dev).manual_seed(0)).eval()
    eng = Engine(model, num_slots=2, max_len=64, paged=True, device=dev)
    loop = EngineLoop(eng)
    loop.start()
    return loop


if __name__ == "__main__":
    sys.exit(main())
