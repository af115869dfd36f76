"""lockcheck rules: the five concurrency contracts of the serve host.

Each rule reads the per-module :class:`ConcurrencyIndex` — execution
contexts per function, held-lock sets per statement, guarded-by
declarations — and emits findings. The contracts, in order:

- **unguarded-shared-write**: an attribute written from two or more
  execution contexts must have a common lock held at every write (or a
  ``# guarded-by:`` declaration it honors everywhere).
- **lock-order-inversion**: the acquired-while-holding graph must stay
  acyclic, and must respect the committed tier ordering in
  ``analysis/lock_order.json`` when one is loaded.
- **blocking-under-lock**: no host sync, device readback, network or
  file I/O, sleeps, or joins while holding a lock — a blocked holder
  stalls every contending thread (a watchdog dump under the recorder
  lock was exactly this shape).
- **asyncio-blocking-call**: coroutines must route sync I/O through
  ``run_in_executor``; a direct call stalls the whole event loop.
- **leaked-acquire**: a bare ``.acquire()`` needs a try/finally that
  releases the same lock; otherwise an exception leaks the lock and
  every later contender deadlocks. ``with`` is always preferred.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Set, Tuple

from nanosandbox_tpu_torch.analysis.core import Finding
from nanosandbox_tpu_torch.analysis.lockcheck.core import (ModuleContext, Rule,
                                                     register)

# Call names that block the calling thread: device readbacks / host
# syncs (JAX's and torch's), network and file I/O, sleeps, joins.
# Matched on the trailing name of the call, so `time.sleep`, `urllib
# .request.urlopen`, and bare `sleep` all hit.
_BLOCKING_CALLS = {
    "sleep": "time.sleep",
    "host_sync": "host sync (device readback barrier)",
    "block_until_ready": "device readback",
    "device_get": "device readback",
    "item": "device readback",
    "tolist": "device readback",
    "cpu": "device readback",
    "numpy": "device readback",
    "synchronize": "device sync",
    "urlopen": "network I/O",
    "getaddrinfo": "network I/O",
    "create_connection": "network I/O",
    "recv": "socket read",
    "sendall": "socket write",
    "connect": "socket connect",
    "check_call": "subprocess",
    "check_output": "subprocess",
    "run": None,          # subprocess.run only when spelled dotted — see below
    "join": "thread/queue join",
    "makedirs": "filesystem I/O",
    "mkdtemp": "filesystem I/O",
}

# For ambiguous trailing names, require the dotted prefix to confirm.
_REQUIRE_PREFIX = {
    "run": ("subprocess",),
    "join": ("thread", "_thread", "pool", "_pool", "proc", "_proc",
             "worker", "_worker", "queue", "_queue", "t", "th"),
    "connect": ("sock", "socket", "s", "conn"),
    "recv": ("sock", "socket", "s", "conn"),
    "sendall": ("sock", "socket", "s", "conn"),
}

# Sync file I/O that only counts inside async def (handlers and the
# loop thread legitimately write dumps; the event loop must not).
_ASYNC_ONLY_BLOCKING = {"open": "file I/O", "read_text": "file I/O",
                        "write_text": "file I/O"}


def _blocking_kind(callee: str, receiver: str) -> str:
    """Human label when (callee, receiver prefix) is a blocking call,
    else ''. receiver is the dotted expression before the final attr
    ('' for bare names)."""
    if callee not in _BLOCKING_CALLS:
        return ""
    need = _REQUIRE_PREFIX.get(callee)
    if need is not None:
        # Exact match on the receiver's trailing name only: `os.path
        # .join` must NOT satisfy the "join" blocking pattern.
        base = receiver.split(".")[-1].lower() if receiver else ""
        if base not in need:
            return ""
    label = _BLOCKING_CALLS[callee]
    if label is None:
        return f"{receiver}.{callee}" if receiver else callee
    return label


@register
class UnguardedSharedWrite(Rule):
    id = "unguarded-shared-write"
    doc = ("attribute written from two or more execution contexts with "
           "no common lock held at every write, or accessed without its "
           "declared guarded-by lock")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        conc = ctx.conc
        # (class, attr) -> list of (contexts, held, line, qualname)
        writes: Dict[Tuple[str, str], List] = {}
        for info in conc.functions.values():
            for w in info.writes:
                if w.in_init:
                    continue
                writes.setdefault((info.cls or "", w.attr), []).append(
                    (frozenset(info.contexts), frozenset(w.held),
                     w.line, info.qualname))
        for (cls, attr), sites in sorted(writes.items()):
            declared = conc.guarded_by.get((cls, attr))
            contexts = set()
            for ctxs, _held, _line, _q in sites:
                contexts |= ctxs
            if len(contexts) < 2:
                continue
            common = None
            for _ctxs, held, _line, _q in sites:
                common = held if common is None else common & held
            if common:
                continue          # every write shares a lock — guarded
            if declared:
                # Declared lock: flag only the writes not holding it
                # (the guarded-by enforcement below covers reads too).
                continue
            line = min(l for _c, _h, l, _q in sites)
            where = ", ".join(sorted(contexts))
            yield Finding(
                ctx.path, line, 0, self.id,
                f"'{('%s.' % cls) if cls else ''}{attr}' is written from "
                f"multiple execution contexts ({where}) with no common "
                "lock held at every write — guard the writes with one "
                "lock, marshal them onto one thread, or declare the "
                "single-writer design with '# guarded-by: <lock>' plus "
                "a reasoned suppression")
        # guarded-by enforcement: every non-__init__ access to a
        # declared attribute must hold the declared lock.
        for info in conc.functions.values():
            for a in info.accesses:
                declared = conc.guarded_by.get((info.cls or "", a.attr))
                if declared is None or a.in_init:
                    continue
                want = (f"{info.cls}.{declared}" if info.cls
                        else declared)
                if not any(h == want or h.endswith("." + declared)
                           or h == declared for h in a.held):
                    kind = "written" if a.is_write else "read"
                    yield Finding(
                        ctx.path, a.line, 0, self.id,
                        f"'{a.attr}' is declared '# guarded-by: "
                        f"{declared}' but {kind} here without holding "
                        f"it (in {info.qualname})")


@register
class LockOrderInversion(Rule):
    id = "lock-order-inversion"
    doc = ("cycle in the acquired-while-holding lock graph, or an "
           "acquisition that violates the committed tier ordering")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        edges = ctx.conc.lock_edges()
        # Committed-order check: acquiring a strictly EARLIER tier while
        # holding a LATER one inverts the canonical order.
        order = ctx.lock_order
        seen: Set[Tuple[str, str]] = set()
        if order is not None:
            for held, acquired, qual, line in edges:
                hi = order.tier_index(self._match(order, held))
                ai = order.tier_index(self._match(order, acquired))
                if hi is None or ai is None or ai >= hi:
                    continue
                key = (held, acquired)
                if key in seen:
                    continue
                seen.add(key)
                yield Finding(
                    ctx.path, line, 0, self.id,
                    f"acquires '{acquired}' (tier "
                    f"'{order.tiers[ai]}') while holding '{held}' "
                    f"(tier '{order.tiers[hi]}') — inverts the "
                    "committed lock order "
                    f"{' → '.join(order.tiers)}")
        # Cycle check over the module's own graph (works with no
        # ordering file at all — any A-while-B plus B-while-A pair).
        graph: Dict[str, Set[str]] = {}
        where: Dict[Tuple[str, str], int] = {}
        for held, acquired, _qual, line in edges:
            graph.setdefault(held, set()).add(acquired)
            where.setdefault((held, acquired), line)
        for a in sorted(graph):
            for b in sorted(graph[a]):
                if a in graph.get(b, ()) and a < b:
                    yield Finding(
                        ctx.path, where[(a, b)], 0, self.id,
                        f"lock cycle: '{a}' is acquired while holding "
                        f"'{b}' AND '{b}' while holding '{a}' — two "
                        "threads taking them in opposite orders "
                        "deadlock")

    @staticmethod
    def _match(order, lock_id: str) -> str:
        """Map a module-local lock id onto a committed id: exact match
        first, then by trailing '.attr' (the file pins 'Class.attr';
        call-site ids can be 'self.attr' spelled through a local)."""
        if lock_id in order.locks:
            return lock_id
        attr = lock_id.rsplit(".", 1)[-1]
        cands = [k for k in order.locks if k.rsplit(".", 1)[-1] == attr]
        if len(cands) == 1:
            return cands[0]
        return lock_id


@register
class BlockingUnderLock(Rule):
    id = "blocking-under-lock"
    doc = ("blocking call (host sync, device readback, network/file "
           "I/O, sleep, join) while holding a lock")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        conc = ctx.conc
        # Which functions block at all (transitively, same module)?
        blocks: Dict[str, str] = {}
        for q, info in conc.functions.items():
            for call in info.calls:
                kind = _blocking_kind(call.callee,
                                      self._receiver(ctx, call))
                if kind:
                    blocks[q] = kind
                    break
        changed = True
        while changed:
            changed = False
            for q, info in conc.functions.items():
                if q in blocks:
                    continue
                for call in info.calls:
                    for callee in conc._resolve(info, call):
                        if callee.qualname in blocks:
                            blocks[q] = (f"call into "
                                         f"{callee.qualname} "
                                         f"({blocks[callee.qualname]})")
                            changed = True
                            break
                    if q in blocks:
                        break
        for q, info in conc.functions.items():
            for call in info.calls:
                if not call.held:
                    continue
                kind = _blocking_kind(call.callee,
                                      self._receiver(ctx, call))
                if kind:
                    # cond.wait on the lock you hold is the condition-
                    # variable idiom, not a blocking bug.
                    yield Finding(
                        ctx.path, call.line, 0, self.id,
                        f"{kind} while holding "
                        f"{', '.join(call.held)} (in {q}) — a blocked "
                        "holder stalls every contending thread; move "
                        "the slow work outside the lock region")
                    continue
                for callee in conc._resolve(info, call):
                    if (callee.qualname in blocks
                            and callee.qualname != q):
                        yield Finding(
                            ctx.path, call.line, 0, self.id,
                            f"calls {callee.qualname} "
                            f"({blocks[callee.qualname]}) while "
                            f"holding {', '.join(call.held)} (in {q})"
                            " — move the slow work outside the lock "
                            "region")
                        break

    @staticmethod
    def _receiver(ctx: ModuleContext, call) -> str:
        # CallSite keeps only the trailing name; recover the dotted
        # receiver from the source line (cheap, line-local).
        if 0 < call.line <= len(ctx.lines):
            line = ctx.lines[call.line - 1]
            needle = f".{call.callee}("
            i = line.find(needle)
            if i > 0:
                j = i
                while j > 0 and (line[j - 1].isalnum()
                                 or line[j - 1] in "._"):
                    j -= 1
                return line[j:i]
        return ""


@register
class AsyncioBlockingCall(Rule):
    id = "asyncio-blocking-call"
    doc = ("synchronous blocking call inside an async def not routed "
           "through run_in_executor — stalls the whole event loop")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for q, info in ctx.conc.functions.items():
            if not info.is_async:
                continue
            for call in info.calls:
                if call.awaited or call.in_lambda:
                    # awaited → a coroutine; in a lambda → runs on the
                    # executor thread run_in_executor hands it to.
                    continue
                recv = BlockingUnderLock._receiver(ctx, call)
                kind = (_blocking_kind(call.callee, recv)
                        or _ASYNC_ONLY_BLOCKING.get(call.callee, ""))
                if not kind:
                    continue
                yield Finding(
                    ctx.path, call.line, 0, self.id,
                    f"{kind} called synchronously inside async "
                    f"{q} — blocks the event loop; wrap it in "
                    "loop.run_in_executor(None, ...)")


@register
class LeakedAcquire(Rule):
    id = "leaked-acquire"
    doc = ("lock.acquire() without a with-statement or try/finally "
           "release — an exception between acquire and release leaks "
           "the lock and deadlocks every later contender")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for q, info in ctx.conc.functions.items():
            for raw in info.raw_acquires:
                if raw.released_in_finally:
                    continue
                yield Finding(
                    ctx.path, raw.line, 0, self.id,
                    f"'{raw.lock}.acquire()' in {q} has no enclosing "
                    "try/finally that releases it — use 'with "
                    f"{raw.lock}:' (or try/finally) so exceptions "
                    "cannot leak the lock")
