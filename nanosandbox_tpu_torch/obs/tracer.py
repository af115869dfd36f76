"""Span tracer: host-side begin/end spans with Chrome trace-event export.

This package's own copy of nanosandbox_tpu/obs/tracer.py. It answers
"why was THIS request slow", which the registry's aggregates cannot. The
engine records spans from dispatch-time state it already holds on the
host (admission wave composition, decode dispatch, spec verify round),
so tracing reads no device tensor and adds no sync: every recorded value
is a host int/float/str, and a record is one dict build and one deque
append under a lock. A span covers host time only: a ``decode_step``
span is one graph replay (one chunk) from its dispatch to its retire.

Semantics that matter for the pipelined engine: a ``decode_step`` span
is OPENED at dispatch and CLOSED at its retire, which, with one chunk in
flight, happens AFTER the next chunk's dispatch. The exported timeline
therefore shows step k overlapping step k+1, the truth of the pipeline.
Request spans (``queued`` -> ``generate``) carry the request id;
eviction and backfill reuse a slot but never a span, so an exported
request track is exactly one request's life.

Export is Chrome trace-event JSON (the ``{"traceEvents": [...]}``
variant), loadable in Perfetto / chrome://tracing: complete events
(``ph: "X"``) on one track per request (tid = rid + 1, named) plus an
engine track (tid 0) for waves, steps and verify rounds.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ENGINE_TRACK = 0  # tid for engine-wide spans; request rid r rides tid r+1


@dataclass
class Span:
    sid: int
    name: str
    cat: str
    t0: float                       # time.monotonic() at begin
    dur: Optional[float] = None     # seconds; None while open
    rid: Optional[int] = None
    args: dict = field(default_factory=dict)

    @property
    def t1(self) -> Optional[float]:
        return None if self.dur is None else self.t0 + self.dur


class SpanTracer:
    """Bounded in-memory ring of completed spans + the open-span table.

    ``enabled=False`` turns every call into a constant-time no-op (the
    overhead-pin test measures the enabled path; the escape hatch exists
    for experiments, not because the enabled path is hot)."""

    def __init__(self, capacity: int = 8192, enabled: bool = True):
        self.enabled = enabled
        self._t0 = time.monotonic()   # export epoch: ts are relative
        self._ring: deque = deque(maxlen=capacity)
        self._open: Dict[int, Span] = {}
        self._sid = itertools.count(1)
        self._lock = threading.Lock()

    # ------------------------------------------------------------- record
    def begin(self, name: str, cat: str = "engine", *,
              rid: Optional[int] = None, args: Optional[dict] = None,
              ) -> int:
        """Open a span; returns its id (0 when disabled). The caller
        holds only the sid — ending by id keeps the hot path free of
        span-object bookkeeping."""
        if not self.enabled:
            return 0
        sp = Span(sid=next(self._sid), name=name, cat=cat,
                  t0=time.monotonic(), rid=rid, args=dict(args or {}))
        with self._lock:
            self._open[sp.sid] = sp
        return sp.sid

    def end(self, sid: int, args: Optional[dict] = None) -> None:
        """Close a span by id. Unknown/zero sids are ignored so a
        disabled tracer's 0 handles (and double-ends on teardown paths)
        never raise in the serving loop."""
        if not self.enabled or sid == 0:
            return
        now = time.monotonic()
        with self._lock:
            sp = self._open.pop(sid, None)
            if sp is None:
                return
            sp.dur = now - sp.t0
            if args:
                sp.args.update(args)
            self._ring.append(sp)

    def instant(self, name: str, cat: str = "engine", *,
                rid: Optional[int] = None,
                args: Optional[dict] = None) -> None:
        """A zero-duration marker (renders as a thin slice)."""
        if not self.enabled:
            return
        sp = Span(sid=next(self._sid), name=name, cat=cat,
                  t0=time.monotonic(), dur=0.0, rid=rid,
                  args=dict(args or {}))
        with self._lock:
            self._ring.append(sp)

    # ------------------------------------------------------------ queries
    def spans(self, rid: Optional[int] = None,
              last_s: Optional[float] = None) -> List[Span]:
        """Completed spans, optionally filtered to one request id and/or
        the trailing ``last_s`` seconds, oldest first."""
        with self._lock:
            out = list(self._ring)
        if rid is not None:
            out = [s for s in out if s.rid == rid]
        if last_s is not None:
            horizon = time.monotonic() - last_s
            out = [s for s in out if s.t1 is not None and s.t1 >= horizon]
        return out

    def _open_snapshot(self, rid: int) -> List[Span]:
        """Point-in-time copies of one request's still-open spans, with
        duration-so-far and an ``incomplete`` marker. /trace?rid=N must
        show a request SITTING IN THE QUEUE — that is the admission-
        pressure diagnosis the endpoint exists for — not 404 until the
        request is done."""
        now = time.monotonic()
        with self._lock:
            return [Span(sid=sp.sid, name=sp.name, cat=sp.cat, t0=sp.t0,
                         dur=now - sp.t0, rid=sp.rid,
                         args={**sp.args, "incomplete": True})
                    for sp in self._open.values() if sp.rid == rid]

    def open_count(self) -> int:
        """Spans begun but not ended — the orphan detector: after a
        drain this must be zero (a leak means some finish path forgot
        its end, exactly the eviction/backfill bug class)."""
        with self._lock:
            return len(self._open)

    def clear(self) -> None:
        """Drop completed spans (benchmarks clear between warmup and the
        timed window, like reset_latency_stats). Open spans survive —
        they belong to in-flight work."""
        with self._lock:
            self._ring.clear()

    # ------------------------------------------------------------- export
    def export_chrome(self, rid: Optional[int] = None,
                      last_s: Optional[float] = None) -> dict:
        """Chrome trace-event JSON for Perfetto / chrome://tracing.

        With ``rid``: that request's spans PLUS the engine-track spans
        overlapping its lifetime (the decode steps / waves / verify
        rounds that explain its latency). Without: everything in the
        ring (optionally time-bounded)."""
        spans = self.spans(last_s=last_s)
        if rid is not None:
            mine = ([s for s in spans if s.rid == rid]
                    + self._open_snapshot(rid))
            if mine:
                lo = min(s.t0 for s in mine)
                hi = max(s.t1 for s in mine)
                engine_ctx = [s for s in spans
                              if s.rid is None and s.t1 is not None
                              and s.t1 >= lo and s.t0 <= hi]
                spans = sorted(mine + engine_ctx, key=lambda s: s.t0)
            else:
                spans = []
        events: List[dict] = []
        tracks: Dict[int, str] = {}
        for s in spans:
            tid = ENGINE_TRACK if s.rid is None else s.rid + 1
            tracks.setdefault(
                tid, "engine" if s.rid is None else f"request {s.rid}")
            ev = {
                "name": s.name,
                "cat": s.cat,
                "ph": "X",
                "ts": round((s.t0 - self._t0) * 1e6, 3),
                "dur": round((s.dur or 0.0) * 1e6, 3),
                "pid": 0,
                "tid": tid,
                "args": dict(s.args),
            }
            if s.rid is not None:
                ev["args"]["rid"] = s.rid
            events.append(ev)
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "args": {"name": name}}
                for tid, name in sorted(tracks.items())]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}
