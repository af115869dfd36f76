"""Thin stdlib HTTP front end over the continuous-batching Engine.

The counterpart of nanosandbox_tpu/serve/http.py's EngineLoop and
make_server (the single-replica server), with the JAX server's routes,
request and response names:

    POST /generate  {"prompt": str | "prompt_tokens": [int], and any of
                     max_new_tokens, temperature, top_k, top_p, seed,
                     eos_id, deadline_s, slo_class, priority}
                     -> {"id", "tokens", "text", "finish_reason"}
                     (+ "prefix_digest" when prompt blocks were cached);
                     with "migrate": true (a prefill-tier replica) the
                     request prefills here and answers 202 with its
                     serialised handoff ({"id", "migrate": true,
                     "export": <disagg.export_to_wire>}) instead of
                     decoding; 400 for a request the engine rejects (a bad
                     deadline or class included), 429 with Retry-After
                     for a request shed (deadline expired in the queue,
                     or the brownout ladder shedding its class), 503
                     when the engine loop is gone, the engine failed for
                     good, or the server is draining (with Retry-After
                     then), 504 on timeout. Every answer's status lands
                     in the flight recorder as an ``http`` event.
    POST /internal/adopt  body = a 202's ``export``: adopt the migrated
                     chain on this (decode-tier) engine and answer, once
                     the request ends, as /generate does plus
                     ``adopted: true``; 503 + ``retryable: true`` on
                     adoption backpressure (try another decode replica),
                     400 on a payload this pool cannot take (the source
                     falls back colocated).
    POST /internal/export_done  {"rid", "ok", "dst"?, "copied_blocks"?,
                     "bytes"?}: resolve a 202'd handoff at its source.
                     ok=true completes the migration (the chain donated
                     to the prefix cache); ok=false requeues it
                     colocated and answers, once it ends, as /generate
                     does plus ``migrate_fallback: true``. 410 once the
                     handoff was reclaimed (``export_timeout_s`` without
                     a callback: the request was requeued colocated).
    POST /drain     begin a graceful drain (idempotent): requests in
                     flight finish, new ones get 503 + Retry-After, and
                     readiness goes false at once; the body reports the
                     counts in flight and ``drained``.
    POST /profile   {"steps": N} arms a torch.profiler window over the
                     next N engine steps and answers at once with its
                     directory ({"dir", "steps"}); {"cancel": true}
                     disarms a window not yet started. The engine picks
                     the directory: a caller-chosen path would be a
                     remote file-write on an unauthenticated endpoint.
                     409 while a window runs. The result shows in /stats
                     under "profile".
    GET  /healthz   liveness: {"ok": true} while the engine loop runs
                    and the engine has not failed for good, else 503.
    GET  /healthz?ready=1  readiness: {"ok", "ready", "draining"}; false
                    (503, with "reason") while draining, quarantined for
                    recovery, or failed.
    GET  /stats     engine counters, latency percentiles, the SLO
                    ledger, recovery, the fault plan, the watchdogs, the
                    flight ledger's size; the loop's under "loop".
    GET  /metrics   Prometheus text: the engine's registry, the process-
                    global one (warn_once firings, process vitals) and
                    the loop's gauges, in one scrape.
    GET  /trace     Chrome trace-event JSON (Perfetto). ?rid=N: one
                    request's spans and the engine spans overlapping it
                    (a request still queued shows its open span; an
                    unknown rid is a 404); ?last_s=S: the trailing S
                    seconds; no query: the whole span ring.
    GET  /debug/requests  flight-recorder events. ?rid=N: one request's
                    track (404 unknown); ?last_s=S; ?format=jsonl for
                    NDJSON instead of {"events": [...]}.
    GET  /debug/slots | /debug/kvpool | /debug/scheduler  the engine's
                    debug views (per-slot occupancy; pool states,
                    fragmentation and trie; the queue head first, then
                    the migration limbo).
    GET  /debug/prefix_summary  the radix cache's chained digests (what a
                    fleet router refreshes its index of this replica
                    from); it walks the trie, so it runs on the loop
                    thread.

The Engine is single-threaded; EngineLoop is the ONE thread that steps
it, through an EngineSupervisor (serve/recovery.py) when it has one, as
the serve CLI does by default: a fault then recovers in place, and its
clients see only their (token-identical) answers. Handler threads
(ThreadingHTTPServer) hand submissions over through a lock-guarded inbox
and wait on a per-request Event, so N concurrent clients become N rows
of the same batched decode step; ``EngineLoop.call`` runs a function on
the loop thread between steps. The read-only views (/stats, /debug/*,
/trace) read the engine's host state from the handler thread.

This module also holds the fleet's front tier, ``RouterFrontend``: an
asyncio proxy (standard library) routing POST /generate across replica
servers by radix-prefix affinity (serve/router.py, the policy the
in-process Fleet drives), with health polls, failover re-routing,
Retry-After hints aggregated over the ready replicas, and, while a
prefill-role and a decode-role replica are both ready, the two-leg
migration proxy of disaggregated serving.
"""

from __future__ import annotations

import asyncio
import json
import math
import socket
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional
from urllib.parse import parse_qs, urlsplit

from nanosandbox_tpu_torch.obs import (MetricRegistry, global_registry,
                                       render_prometheus)
from nanosandbox_tpu_torch.serve.engine import EngineFailedError


class DrainingError(RuntimeError):
    """Raised to submitters while the loop drains (POST /drain): what is
    in flight finishes, nothing new is taken."""


class _Pending:
    def __init__(self, kwargs: dict):
        self.kwargs = kwargs
        self.done = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None


@dataclass
class ExportPayload:
    """What a migrate-flagged /generate waiter receives in place of a
    Result when its request exports: the serialised handoff
    (disagg.export_to_wire), answered as a 202. The router frontend
    carries it to a decode replica's /internal/adopt and resolves it
    here through /internal/export_done."""
    rid: int
    wire: dict


class EngineLoop(threading.Thread):
    """Background thread that owns the Engine: drains the submission
    inbox, steps while any request is in flight, sleeps otherwise.
    ``drain_now()`` turns draining on: requests in flight finish, new
    submissions get DrainingError (503 upstream) and readiness goes
    red. Exports answered 202 wait for their /internal/export_done
    callback; after ``export_timeout_s`` without one they are requeued
    colocated, so a lost frontend cannot strand a request."""

    def __init__(self, engine, supervisor=None,
                 export_timeout_s: float = 60.0):
        super().__init__(daemon=True, name="serve-engine-loop")
        self.engine = engine
        self.supervisor = supervisor
        self._stepper = supervisor if supervisor is not None else engine
        self._cond = threading.Condition()
        self._inbox: list[_Pending] = []
        self._by_rid: dict[int, _Pending] = {}
        self._taken: list[_Pending] = []     # being handed to the engine
        self._calls: list[tuple[Callable, _Pending]] = []
        # rid -> (export, monotonic stamp): handoffs answered 202 that
        # await the frontend's export_done callback.
        self._exports: dict[int, tuple] = {}
        self.export_timeout_s = float(export_timeout_s)
        self._stopping = False
        self.draining = False
        # Set when the loop dies on an engine error: /healthz goes red.
        self.dead: Optional[str] = None

    def submit(self, **kwargs) -> _Pending:
        """Thread-safe: queue a request for the loop thread."""
        p = _Pending(kwargs)
        with self._cond:
            if self.dead is not None:
                p.error = RuntimeError(f"engine loop died: {self.dead}")
                p.done.set()
            elif self.draining:
                p.error = DrainingError(
                    "server draining; retry against another replica")
                p.done.set()
            else:
                self._inbox.append(p)
                self._cond.notify()
        return p

    def generate(self, timeout: Optional[float] = None, **kwargs):
        """submit + wait; raises the engine's validation error if any."""
        p = self.submit(**kwargs)
        if not p.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def call(self, fn: Callable, timeout: Optional[float] = 30.0):
        """Run ``fn(engine)`` ON the loop thread, between steps, and
        return its result (handler threads never mutate the engine)."""
        p = _Pending({})
        with self._cond:
            if self.dead is not None:
                raise RuntimeError(f"engine loop died: {self.dead}")
            self._calls.append((fn, p))
            self._cond.notify()
        if not p.done.wait(timeout):
            raise TimeoutError("engine loop call timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def adopt(self, wire: dict, *, src: str = ""):
        """Adopt one migrated export on this (decode-tier) engine, on the
        loop thread. Returns a waiter for the adopted request's terminal
        Result, the Result itself when adoption finishes it at once, or
        None on adoption backpressure (no free slot or blocks)."""
        from nanosandbox_tpu_torch.serve.disagg import adopt_from_wire

        def fn(eng):
            got = adopt_from_wire(eng, wire, src=src)
            if got is None:
                return None
            rid, done = got
            if done is not None:
                return done
            p = _Pending({})
            self._by_rid[rid] = p
            return p

        return self.call(fn)

    def export_done(self, rid: int, ok: bool, *, dst: str = "",
                    copied_blocks: int = 0, bytes_moved: int = 0):
        """Resolve one proxied handoff: ok=True completes the migration
        (the chain donated); ok=False requeues the request colocated
        under its rid and returns a waiter for its terminal Result.
        Returns True, a waiter, or None when the export is unknown
        (reclaimed by the timeout, or never exported)."""

        def fn(eng):
            entry = self._exports.pop(rid, None)
            if entry is None:
                return None
            exp, _ = entry
            if ok:
                eng.complete_export(
                    exp, dst=dst, blocks_copied=copied_blocks,
                    bytes_moved=bytes_moved,
                    migrate_s=time.monotonic() - exp.export_t)
                return True
            p = _Pending({})
            self._by_rid[rid] = p
            eng.requeue_export(exp)
            return p

        return self.call(fn)

    def stop(self) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify()

    def drain_now(self) -> dict:
        """Begin draining (idempotent): refuse new submissions and keep
        stepping until the work in flight retires. Returns the progress:
        readiness is false from this moment."""
        with self._cond:
            self.draining = True
            self._cond.notify()
            in_flight = len(self._inbox) + len(self._by_rid)
        eng = self.engine
        return {"draining": True,
                "in_flight": in_flight,
                "engine_active": len(eng._active),
                "queued": eng.sched.queued,
                "drained": not eng.has_work() and in_flight == 0}

    def is_live(self) -> tuple[bool, str]:
        """Liveness: False once the loop is dead or the engine failed for
        good (restart-to-fix states)."""
        if self.dead is not None:
            return False, f"engine loop died: {self.dead}"
        if not self.is_alive():
            return False, "engine loop not running"
        if self.engine.failed:
            return False, "engine permanently failed"
        return True, "ok"

    def is_ready(self) -> tuple[bool, str]:
        """Readiness: can this replica take a request now? Also False
        while the engine is quarantined for recovery."""
        live, reason = self.is_live()
        if not live:
            return live, reason
        if self.draining:
            return False, "draining"
        if self.engine.quarantined:
            return False, f"quarantined: {self.engine.quarantine_cause}"
        sup = self.supervisor
        if sup is not None and sup.state != "ok":
            return False, f"supervisor state {sup.state}"
        return True, "ok"

    def stats(self) -> dict:
        with self._cond:
            out = {"inbox": len(self._inbox), "waiting": len(self._by_rid),
                   "draining": self.draining, "dead": self.dead}
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor.stats()
        return out

    def run(self) -> None:
        try:
            self._serve()
        except Exception as e:
            # An engine failure wedges every request it holds, the chunk
            # in flight's included: fail all waiters now instead of
            # letting them time out, mark the loop dead so /healthz goes
            # red, and exit.
            with self._cond:
                self.dead = f"{type(e).__name__}: {e}"
                self._fail_all(RuntimeError(
                    f"engine loop died: {self.dead}"))
            raise

    def _serve(self) -> None:
        """Hand the inbox to the engine and step while it has work (a
        chunk in flight counts: Engine.has_work)."""
        while True:
            with self._cond:
                while (not self._stopping and not self._inbox
                       and not self._calls and not self.engine.has_work()):
                    # With 202'd handoffs pending, wake on a timer so
                    # their timeout reclaims them without new traffic.
                    if not self._cond.wait(1.0 if self._exports else None):
                        break
                if self._stopping:
                    self._fail_all(RuntimeError("server shutting down"))
                    return
                self._taken, self._inbox = self._inbox, []
                calls, self._calls = self._calls, []
            for fn, p in calls:
                try:
                    p.result = fn(self.engine)
                except Exception as e:
                    p.error = e
                p.done.set()
            for p in self._taken:
                try:
                    rid = self.engine.submit(**p.kwargs)
                    self._by_rid[rid] = p
                except (ValueError, EngineFailedError) as e:
                    p.error = e             # admission rules -> the caller
                    p.done.set()
            self._taken = []
            for res in self._stepper.step():
                p = self._by_rid.pop(res.rid, None)
                if p is not None:
                    p.result = res
                    p.done.set()
            self._pump_exports()

    def _pump_exports(self) -> None:
        """Hand this step's exports to their waiters as ExportPayloads
        (202 upstream), and requeue colocated an export nobody waits for
        (a direct submit, a client gone) or one past export_timeout_s
        without its callback: each request still ends once."""
        from nanosandbox_tpu_torch.serve.disagg import export_to_wire

        eng = self.engine
        now = time.monotonic()
        for rid, (exp, t0) in list(self._exports.items()):
            if now - t0 > self.export_timeout_s:
                del self._exports[rid]
                eng.requeue_export(exp)
        while True:
            exp = eng.pop_export()
            if exp is None:
                return
            p = self._by_rid.pop(exp.rid, None)
            if p is None:
                eng.requeue_export(exp)
                continue
            try:
                wire = export_to_wire(eng, exp)
            except Exception:
                self._by_rid[exp.rid] = p
                eng.requeue_export(exp)
                continue
            self._exports[exp.rid] = (exp, now)
            p.result = ExportPayload(rid=exp.rid, wire=wire)
            p.done.set()

    def _fail_all(self, err: Exception) -> None:
        """Signal every waiter (call with self._cond held): the inbox, the
        submissions being handed over, and every request the engine
        holds."""
        for p in (*self._inbox, *self._taken, *self._by_rid.values(),
                  *(p for _, p in self._calls)):
            if not p.done.is_set():
                p.error = err
                p.done.set()
        self._inbox, self._taken, self._by_rid = [], [], {}
        self._calls = []


def make_server(host: str, port: int, loop: EngineLoop,
                encode: Optional[Callable[[str], list]] = None,
                decode: Optional[Callable[[list], str]] = None,
                request_timeout: float = 300.0) -> ThreadingHTTPServer:
    """HTTP server bound to an EngineLoop (routes in the module
    docstring). Without a tokenizer (``encode``/``decode`` None), text
    prompts are a 400 and responses carry "text": null; prompt_tokens
    requests need none."""

    # The loop's in-flight accounting as gauges, collected per scrape.
    loop_reg = MetricRegistry()
    g_inbox = loop_reg.gauge("serve_loop_inbox_depth",
                             "Requests parked in the loop inbox.")
    g_waiting = loop_reg.gauge("serve_loop_waiting",
                               "Requests whose waiters are still blocked.")
    g_dead = loop_reg.gauge("serve_loop_dead",
                            "1 when the engine loop has died, else 0.")
    g_draining = loop_reg.gauge("serve_loop_draining",
                                "1 while the loop is draining, else 0.")

    def _collect_loop():
        st = loop.stats()
        g_inbox.set(st["inbox"])
        g_waiting.set(st["waiting"])
        g_dead.set(0.0 if st["dead"] is None else 1.0)
        g_draining.set(1.0 if st["draining"] else 0.0)

    loop_reg.add_collector(_collect_loop)

    def retry_after(slo_class: Optional[str]) -> int:
        """Whole seconds for a Retry-After, scaled by the queue mass
        ahead of the requester's class (Engine.retry_after_s)."""
        return max(1, math.ceil(
            loop.engine.retry_after_s(slo_class=slo_class)))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # stdout stays quiet
            pass

        def _text(self, code: int, body: str, ctype: str,
                  headers: Optional[dict] = None) -> None:
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(data)

        def _json(self, code: int, obj: dict,
                  headers: Optional[dict] = None) -> None:
            self._text(code, json.dumps(obj), "application/json", headers)

        def _gen_respond(self, code: int, obj: dict,
                         rid: Optional[int] = None,
                         headers: Optional[dict] = None) -> None:
            """A /generate answer; the flight recorder keeps the status
            the client was given."""
            loop.engine.flight.record("http", rid=rid, status=code)
            self._json(code, obj, headers)

        def _query(self, q: dict) -> tuple:
            rid = int(q["rid"][0]) if "rid" in q else None
            last_s = float(q["last_s"][0]) if "last_s" in q else None
            return rid, last_s

        def do_GET(self):
            url = urlsplit(self.path)
            path = url.path
            q = parse_qs(url.query)
            if path == "/healthz" and q.get("ready", ["0"])[0] not in (
                    "0", "", "false"):
                ready, reason = loop.is_ready()
                body = {"ok": ready, "ready": ready,
                        "draining": loop.draining}
                if ready:
                    self._json(200, body)
                else:
                    self._json(503, dict(body, reason=reason),
                               headers={"Retry-After": retry_after(None)})
            elif path == "/healthz":
                live, reason = loop.is_live()
                self._json(200 if live else 503,
                           {"ok": live} if live else
                           {"ok": False, "error": reason})
            elif path == "/stats":
                stats = loop.engine.stats()
                stats["loop"] = loop.stats()
                self._json(200, stats)
            elif path == "/metrics":
                try:
                    body = render_prometheus(loop.engine.metrics,
                                             global_registry(), loop_reg)
                except ValueError as e:
                    # A family in two registries (an engine built on the
                    # global registry): a diagnosable 500.
                    self._json(500, {"error": str(e)})
                    return
                self._text(200, body,
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/trace":
                try:
                    rid, last_s = self._query(q)
                except (ValueError, TypeError) as e:
                    self._json(400, {"error": f"bad query: {e!r}"})
                    return
                trace = loop.engine.tracer.export_chrome(rid=rid,
                                                         last_s=last_s)
                if rid is not None and not trace["traceEvents"]:
                    self._json(404, {"error": f"no spans for rid {rid} "
                                              "(unknown id, or rotated "
                                              "out of the span ring)"})
                    return
                self._json(200, trace)
            elif path == "/debug/requests":
                try:
                    rid, last_s = self._query(q)
                    fmt = q.get("format", ["json"])[0]
                except (ValueError, TypeError) as e:
                    self._json(400, {"error": f"bad query: {e!r}"})
                    return
                flight = loop.engine.flight
                if rid is not None and not flight.events(rid=rid):
                    self._json(404, {"error": f"no flight events for rid "
                                              f"{rid} (unknown id, or "
                                              "rotated out of the ring)"})
                    return
                if fmt == "jsonl":
                    self._text(200, flight.to_jsonl(rid=rid, last_s=last_s),
                               "application/x-ndjson")
                else:
                    self._json(200, {"events": flight.events(
                        rid=rid, last_s=last_s)})
            elif path == "/debug/slots":
                self._json(200, loop.engine.debug_slots())
            elif path == "/debug/kvpool":
                self._json(200, loop.engine.debug_kvpool())
            elif path == "/debug/scheduler":
                self._json(200, loop.engine.debug_scheduler())
            elif path == "/debug/prefix_summary":
                # The trie walk runs on the loop thread: a handler-thread
                # walk would race the loop's inserts and evictions.
                try:
                    summary = loop.call(lambda eng: eng.prefix_summary())
                except RuntimeError:
                    # The loop is dead: nothing mutates the trie anymore.
                    summary = loop.engine.prefix_summary()
                except TimeoutError:
                    self._json(503, {"error": "engine loop busy; retry "
                                              "prefix_summary"})
                    return
                self._json(200, summary)
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            return payload

        def do_POST(self):
            if self.path == "/drain":
                self._json(200, {"ok": True, **loop.drain_now()})
                return
            if self.path == "/profile":
                try:
                    payload = self._body()
                    if payload.get("cancel"):
                        self._json(200, {"ok": True, "cancelled":
                                         loop.engine.cancel_profile()})
                        return
                    res = loop.engine.request_profile(
                        int(payload.get("steps", 20)))
                except (ValueError, TypeError) as e:
                    self._json(400, {"error": f"bad request: {e!r}"})
                    return
                except RuntimeError as e:   # a window is running
                    self._json(409, {"error": str(e)})
                    return
                self._json(200, {"ok": True, **res})
                return
            if self.path == "/internal/adopt":
                self._do_internal_adopt()
                return
            if self.path == "/internal/export_done":
                self._do_internal_export_done()
                return
            if self.path != "/generate":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                payload = self._body()
                if "prompt_tokens" in payload:
                    prompt = [int(t) for t in payload["prompt_tokens"]]
                elif encode is None:
                    raise ValueError("this server has no tokenizer: send "
                                     "prompt_tokens")
                else:
                    prompt = encode(str(payload.get("prompt", ""))) or [0]
                kwargs = dict(
                    prompt=prompt,
                    max_new_tokens=int(payload.get("max_new_tokens", 64)),
                    temperature=float(payload.get("temperature", 0.8)),
                    top_k=int(payload.get("top_k", 0)),
                    top_p=float(payload.get("top_p", 1.0)),
                    seed=int(payload.get("seed", 0)),
                )
                if payload.get("eos_id") is not None:
                    kwargs["eos_id"] = int(payload["eos_id"])
                if payload.get("deadline_s") is not None:
                    kwargs["deadline_s"] = float(payload["deadline_s"])
                if payload.get("slo_class") is not None:
                    kwargs["slo_class"] = str(payload["slo_class"])
                if payload.get("priority") is not None:
                    kwargs["priority"] = int(payload["priority"])
                if payload.get("migrate"):
                    # Prefill here, then answer 202 with the serialised
                    # block chain instead of decoding.
                    kwargs["migrate"] = True
            except (ValueError, TypeError, KeyError) as e:
                # KeyError: a char tokenizer meeting an out-of-vocab char.
                self._gen_respond(400, {"error": f"bad request: {e!r}"})
                return
            try:
                res = loop.generate(timeout=request_timeout, **kwargs)
            except ValueError as e:
                self._gen_respond(400, {"error": str(e)})
                return
            except TimeoutError as e:
                self._gen_respond(504, {"error": str(e)})
                return
            except (EngineFailedError, DrainingError) as e:
                self._gen_respond(503, {"error": str(e)},
                                  headers={"Retry-After": retry_after(None)})
                return
            except RuntimeError as e:
                self._gen_respond(503, {"error": str(e)})
                return
            if isinstance(res, ExportPayload):
                # Accepted, not finished: the caller (the router
                # frontend) resolves it through a decode replica and
                # /internal/export_done, or the timeout reclaims it.
                self._gen_respond(202, {"id": res.rid, "migrate": True,
                                        "export": res.wire}, rid=res.rid)
                return
            self._respond_result(res, kwargs.get("slo_class", "default"))

        def _respond_result(self, res, slo_class: Optional[str] = None,
                            extra: Optional[dict] = None) -> None:
            """A terminal Result as /generate's answer (``extra`` merged
            into the body)."""
            if res.finish_reason == "shed":
                # The engine is healthy; this request lost its place.
                # tokens are non-empty only for a preempted request shed
                # before its resume (what it had generated).
                cls = slo_class or "default"
                self._gen_respond(429, {"error": "shed: deadline expired "
                                                 "in the queue (or "
                                                 "brownout shed)",
                                        "id": res.rid, "tokens": res.tokens,
                                        "finish_reason": "shed",
                                        "slo_class": cls, **(extra or {})},
                                  rid=res.rid,
                                  headers={"Retry-After": retry_after(cls)})
                return
            if res.finish_reason == "failed":
                self._gen_respond(503, {"error": "generation failed (non-"
                                                 "finite logits, or the "
                                                 "engine failed for good)",
                                        "id": res.rid, "tokens": res.tokens,
                                        "finish_reason": "failed",
                                        **(extra or {})},
                                  rid=res.rid)
                return
            body = {"id": res.rid, "tokens": res.tokens,
                    "text": (decode(list(res.prompt) + res.tokens)
                             if decode is not None else None),
                    "finish_reason": res.finish_reason}
            if res.prefix_digest:
                # What this replica's radix cache now holds for the
                # prompt: a fleet router reads it from the body.
                body["prefix_digest"] = list(res.prefix_digest)
            body.update(extra or {})
            self._gen_respond(200, body, rid=res.rid)

        def _wait_result(self, p: _Pending):
            """A waiter's Result, or None once an error answer was sent."""
            if not p.done.wait(request_timeout):
                self._json(504, {"error": "generation timed out"})
                return None
            if p.error is not None:
                self._json(503, {"error": str(p.error)})
                return None
            return p.result

        def _do_internal_adopt(self):
            try:
                wire = self._body()
                if "leaves" not in wire:
                    raise ValueError("body must be an export payload "
                                     "(disagg.export_to_wire)")
                src = str(wire.get("src", ""))
            except (ValueError, TypeError) as e:
                self._json(400, {"error": f"bad request: {e!r}"})
                return
            try:
                got = loop.adopt(wire, src=src)
            except (ValueError, KeyError, IndexError) as e:
                # A payload this pool cannot take: the source falls back
                # colocated rather than trying another decode replica.
                self._json(400, {"error": f"bad export payload: {e!r}"})
                return
            except (RuntimeError, TimeoutError) as e:
                self._json(503, {"error": str(e)})
                return
            if got is None:
                self._json(503, {"error": "adoption backpressure: no free "
                                          "slot or blocks",
                                 "retryable": True},
                           headers={"Retry-After": retry_after(None)})
                return
            res = got if not isinstance(got, _Pending) else \
                self._wait_result(got)
            if res is not None:
                self._respond_result(res, wire.get("slo_class"),
                                     {"adopted": True})

        def _do_internal_export_done(self):
            try:
                payload = self._body()
                rid = int(payload["rid"])
                ok = bool(payload.get("ok"))
                dst = str(payload.get("dst", ""))
                copied = int(payload.get("copied_blocks", 0))
                nbytes = int(payload.get("bytes", 0))
            except (ValueError, TypeError, KeyError) as e:
                self._json(400, {"error": f"bad request: {e!r}"})
                return
            try:
                got = loop.export_done(rid, ok, dst=dst,
                                       copied_blocks=copied,
                                       bytes_moved=nbytes)
            except (RuntimeError, TimeoutError) as e:
                self._json(503, {"error": str(e)})
                return
            if got is None:
                self._json(410, {"error": f"unknown export rid {rid} "
                                          "(reclaimed or never exported)"})
                return
            if got is True:
                self._json(200, {"ok": True, "id": rid})
                return
            # ok=False: requeued colocated; answer with its terminal, so
            # the client gets exactly one answer.
            res = self._wait_result(got)
            if res is not None:
                self._respond_result(res, extra={"migrate_fallback": True})

    return _Server((host, port), Handler)


class _Server(ThreadingHTTPServer):
    """The front end's listening socket with socket.SOMAXCONN pending
    connections, not socketserver's 5: the accept thread shares the GIL
    with the stepping thread, and a burst of concurrent clients that
    overflows the queue loses a SYN, which the client resends only after
    a second (one request of eight admitted 1 s late, on the H100)."""
    request_queue_size = socket.SOMAXCONN


# ---------------------------------------------------------------------------
# The fleet's front tier: an asyncio HTTP proxy over replica base URLs,
# routing POST /generate by radix-prefix affinity (serve/router.py, the
# policy the in-process Fleet drives) with health-poll readiness, failover
# re-routing and aggregated Retry-After hints. asyncio rather than a
# thread a request: the tier holds many proxied requests that each mostly
# wait on a replica's socket; the blocking urllib legs run on executors.
# ---------------------------------------------------------------------------

def _http_json(url: str, *, method: str = "GET", body: Optional[dict]
               = None, timeout: float = 5.0) -> tuple[int, dict, dict]:
    """One blocking JSON HTTP call -> (status, body, headers). HTTP
    error statuses return normally (the proxy forwards them); only
    transport failures raise (URLError / timeout / bad JSON)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}"), dict(
                r.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            payload = json.loads(raw or b"{}")
        except json.JSONDecodeError:
            payload = {"error": raw.decode(errors="replace")}
        return e.code, payload, dict(e.headers or {})


def resolve_replicas(spec: str, default_port: int = 8000) -> List[str]:
    """Expand one --replicas entry into base URLs. Plain http://host:port
    entries pass through; ``dns+http://name:port`` resolves the name's
    A records (a k8s HEADLESS Service: one record per ready pod) into
    one URL per address — re-resolved every health interval, which is
    how the router tracks scale-up/down without redeploys."""
    if not spec.startswith("dns+http://"):
        return [spec.rstrip("/")]
    hostport = spec[len("dns+http://"):].rstrip("/")
    host, _, port = hostport.partition(":")
    port = int(port or default_port)
    try:
        infos = socket.getaddrinfo(host, port, proto=socket.IPPROTO_TCP)
    except OSError:
        return []
    addrs = sorted({info[4][0] for info in infos})
    # Bracket IPv6 literals (dual-stack headless Services return AAAA
    # records too) — an unbracketed v6 host:port is not a URL.
    return [f"http://[{a}]:{port}" if ":" in a else f"http://{a}:{port}"
            for a in addrs]


class RouterFrontend:
    """Prefix-affinity routing proxy over replica base URLs.

    Lifecycle: construct, ``start()`` (binds and spawns the event-loop
    thread; ``port`` is the bound port), ``stop()``. Per replica, every
    ``health_interval_s``: GET /healthz?ready=1 (readiness — a
    draining/quarantined/dead replica leaves rotation within one
    interval), GET /stats (queue depth, active rows, brownout level,
    the replica's own retry_after_s estimate), and
    GET /debug/prefix_summary (the authoritative radix digests the
    approximate router index refreshes from).

    POST /generate proxies to the routed replica. Affinity needs the
    prompt's digest chain, which needs token ids: requests carrying
    ``prompt_tokens`` route by affinity; text-only prompts (tokenized
    replica-side) route by load — documented, not hidden. A transport
    failure or 503 marks the replica not-ready and re-routes
    (``fallback``) until the ready set is exhausted; 429/503 responses
    carry a Retry-After aggregated as the MIN over ready replicas'
    polled estimates (never just the shedding replica's) and a body
    naming the ready ``replica_set`` size.

    Disaggregated serving: replicas announce their tier via
    /stats ("role": prefill | decode | both). While BOTH tiers have a
    ready member, /generate becomes a two-leg migration proxy — leg 1
    routes phase="prefill" with the migrate flag and gets a 202 export
    (the paged block chain as the wire format); leg 2 carries it to a
    decode replica's /internal/adopt and confirms at the source with
    /internal/export_done (adopt exhaustion => ok=false, the source
    requeues colocated — the client always gets exactly one answer).
    Mixed rollouts and tier outages degrade to the legacy colocated
    flow automatically.

    Own endpoints: GET /healthz[?ready=1] (ready while >= 1 replica
    is), GET /debug/router (router + per-replica view), GET /metrics
    (the serve_router_* families plus the serve_migrations ledger).
    """

    def __init__(self, replicas: List[str], *, host: str = "0.0.0.0",
                 port: int = 8000, page: int = 16,
                 health_interval_s: float = 2.0,
                 request_timeout_s: float = 300.0,
                 affinity: bool = True, index_cap: int = 8192,
                 default_port: int = 8000):
        from nanosandbox_tpu_torch.serve.router import PrefixAffinityRouter

        self._specs = list(replicas)
        self.host = host
        self.port = port
        self.page = int(page)
        self.health_interval_s = float(health_interval_s)
        self.request_timeout_s = float(request_timeout_s)
        self.default_port = int(default_port)
        urls: List[str] = []
        for spec in self._specs:
            urls.extend(resolve_replicas(spec, default_port))
        self.metrics = MetricRegistry()
        # Disaggregated serving: the frontend is the
        # migration proxy, so the migration ledger lives here too —
        # same family names the in-process DisaggPair exposes.
        self._m_migrations = self.metrics.counter(
            "serve_migrations_total",
            "Prefill->decode migrations proxied, by outcome.",
            labelnames=("outcome",))
        self._m_migration_s = self.metrics.histogram(
            "serve_migration_seconds",
            "Wall seconds from 202 export to decode-tier adoption.")
        self.router = PrefixAffinityRouter(
            urls or ["http://unresolved.invalid:0"], page=page,
            affinity=affinity, index_cap=index_cap,
            metrics=self.metrics)
        if not urls:
            self.router.remove_replica("http://unresolved.invalid:0")
        self._retry_by_replica: Dict[str, float] = {}
        # Proxy legs block a thread for the request's whole generation
        # (up to request_timeout_s): give them their OWN pool so long
        # decodes can never starve the health polls — which run on the
        # loop's default executor — out of their interval (the
        # "leaves rotation within one health interval" contract).
        from concurrent.futures import ThreadPoolExecutor

        self._proxy_pool = ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="router-proxy")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._stopping: Optional[asyncio.Event] = None

    # ------------------------------------------------------------ health
    def _poll_replica(self, url: str) -> None:
        """One replica's health refresh (blocking; runs on the
        executor). Any transport failure = not ready. Per-call timeout
        is capped at the health interval: a BLACK-HOLED replica (node
        gone, connections hang instead of refusing) must still leave
        rotation within ~one interval, not after 3 x 5s of sequential
        hangs — the 'leaves rotation within one health interval'
        contract is only as tight as this timeout."""
        t = max(0.25, min(5.0, self.health_interval_s))
        try:
            st, body, _ = _http_json(f"{url}/healthz?ready=1", timeout=t)
            ready = st == 200 and bool(body.get("ready", body.get("ok")))
            reason = body.get("reason", "ok" if ready else "not ready")
            queued = active = brownout = 0
            role = None
            if ready:
                _, stats, _ = _http_json(f"{url}/stats", timeout=t)
                queued = int(stats.get("queued", 0))
                active = int(stats.get("active", 0))
                bo = stats.get("brownout") or {}
                brownout = int(bo.get("level", 0))
                # Phase discovery: replicas announce their
                # tier in /stats ("prefill"/"decode"/"both"); the router
                # grows its phase dimension from the polls, no separate
                # registration step.
                r = stats.get("role")
                if r in ("both", "prefill", "decode"):
                    role = r
                retry = stats.get("retry_after_s")
                if retry is not None:
                    self._retry_by_replica[url] = float(retry)
                _, summary, _ = _http_json(f"{url}/debug/prefix_summary",
                                           timeout=t)
                self.router.refresh_summary(
                    url, summary.get("digests") or [])
        except Exception as e:       # noqa: BLE001 — any poll failure
            ready, reason = False, f"unreachable: {type(e).__name__}"
            queued = active = brownout = 0
            role = None
        self.router.update_replica(url, ready=ready, reason=reason,
                                   queued=queued, active=active,
                                   brownout=brownout, role=role,
                                   retry_after_s=self._retry_by_replica
                                   .get(url))

    async def _health_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopping.is_set():
            urls: List[str] = []
            for spec in self._specs:
                urls.extend(await loop.run_in_executor(
                    None, resolve_replicas, spec, self.default_port))
            if urls:
                for url in urls:
                    self.router.add_replica(url)
                for known in list(self.router.replicas):
                    if known not in urls:
                        self.router.remove_replica(known)
            else:
                # A resolver blip (kube-dns restart, transient timeout)
                # must not deregister the whole fleet — that would turn
                # one failed lookup into a full 503 outage AND discard
                # every warm prefix index. Keep the known set; the
                # per-replica polls below mark truly-dead ones
                # not-ready, which is the correct degradation.
                urls = list(self.router.replicas)
            await asyncio.gather(*(
                loop.run_in_executor(None, self._poll_replica, url)
                for url in urls), return_exceptions=True)
            try:
                await asyncio.wait_for(self._stopping.wait(),
                                       self.health_interval_s)
            except asyncio.TimeoutError:
                pass

    def retry_after_s(self) -> float:
        """Aggregate backoff hint: min over READY replicas of their
        own polled estimates — fallback 1s when cold."""
        ready = self.router.ready_replicas()
        vals = [self._retry_by_replica[r] for r in ready
                if r in self._retry_by_replica]
        return min(vals) if vals else 1.0

    # ------------------------------------------------------------- serve
    async def _respond(self, writer: asyncio.StreamWriter, code: int,
                       body: dict, headers: Optional[dict] = None
                       ) -> None:
        phrase = {200: "OK", 202: "Accepted", 400: "Bad Request",
                  404: "Not Found", 410: "Gone",
                  429: "Too Many Requests", 502: "Bad Gateway",
                  503: "Service Unavailable",
                  504: "Gateway Timeout"}.get(code, "OK")
        data = json.dumps(body).encode()
        head = [f"HTTP/1.1 {code} {phrase}",
                "Content-Type: application/json",
                f"Content-Length: {len(data)}", "Connection: close"]
        for k, v in (headers or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
        await writer.drain()
        writer.close()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request_line = (await reader.readline()).decode()
            parts = request_line.split()
            if len(parts) < 2:
                writer.close()
                return
            method, path = parts[0], parts[1]
            length = 0
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode().partition(":")
                if name.strip().lower() == "content-length":
                    length = int(value.strip())
            raw = await reader.readexactly(length) if length else b""
            await self._route_request(method, path, raw, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            writer.close()
        except Exception as e:      # noqa: BLE001 — proxy must answer
            try:
                await self._respond(writer, 502,
                                    {"error": f"router error: {e!r}"})
            except ConnectionError:
                writer.close()

    async def _route_request(self, method: str, path: str, raw: bytes,
                             writer: asyncio.StreamWriter) -> None:
        url = urlsplit(path)
        if method == "GET" and url.path == "/healthz":
            ready = bool(self.router.ready_replicas())
            body = {"ok": ready, "ready": ready,
                    "replica_set": len(self.router.ready_replicas()),
                    "replicas": len(self.router.replicas)}
            await self._respond(writer, 200 if ready else 503, body)
            return
        if method == "GET" and url.path == "/debug/router":
            await self._respond(writer, 200, {
                "router": self.router.stats(),
                "retry_after_s": self.retry_after_s(),
                "health_interval_s": self.health_interval_s})
            return
        if method == "GET" and url.path == "/metrics":
            data = render_prometheus(self.metrics).encode()
            writer.write(
                b"HTTP/1.1 200 OK\r\nContent-Type: text/plain; "
                b"version=0.0.4; charset=utf-8\r\nContent-Length: "
                + str(len(data)).encode()
                + b"\r\nConnection: close\r\n\r\n" + data)
            await writer.drain()
            writer.close()
            return
        if method != "POST" or url.path != "/generate":
            await self._respond(writer, 404,
                                {"error": f"no route {path}"})
            return
        try:
            payload = json.loads(raw or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            await self._respond(writer, 400,
                                {"error": f"bad request: {e!r}"})
            return
        chain: List[str] = []
        if isinstance(payload.get("prompt_tokens"), list) and self.page:
            from nanosandbox_tpu_torch.serve.paged import prefix_digests
            try:
                chain = prefix_digests(
                    [int(t) for t in payload["prompt_tokens"]], self.page)
            except (TypeError, ValueError):
                chain = []
        await self._proxy_generate(payload, chain, writer)

    def _phase_tiering(self) -> bool:
        """True when the fleet is actually disaggregated RIGHT NOW: at
        least one ready prefill-role replica AND one ready decode-role
        replica. Anything less (mixed rollout, decode tier down) routes
        the legacy colocated way — graceful degradation, not an
        outage."""
        views = self.router.replicas
        ready = [views[n] for n in self.router.ready_replicas()
                 if n in views]
        return (any(r.role == "prefill" for r in ready)
                and any(r.role == "decode" for r in ready))

    async def _proxy_generate(self, payload: dict, chain: List[str],
                              writer: asyncio.StreamWriter) -> None:
        from nanosandbox_tpu_torch.serve.router import NoReadyReplicaError

        loop = asyncio.get_running_loop()
        tried: set = set()
        slo = payload.get("slo_class")
        # Disaggregated two-leg flow: with both tiers ready,
        # leg 1 routes phase="prefill" with the migrate flag; the 202
        # export it answers with becomes leg 2's /internal/adopt body.
        tiered = self._phase_tiering() and not payload.get(
            "_no_migrate")
        while True:
            try:
                dec = self.router.route(
                    chain, exclude=tried, failover=bool(tried),
                    phase="prefill" if tiered else None)
            except NoReadyReplicaError as e:
                if tiered:
                    # The prefill tier emptied mid-flight: retry the
                    # whole ready set colocated before giving up.
                    tiered = False
                    continue
                await self._respond(
                    writer, 503,
                    {"error": str(e), "replica_set": 0,
                     "tried": sorted(tried)},
                    {"Retry-After": max(1, math.ceil(
                        self.retry_after_s()))})
                return
            name = dec.replica
            if chain:
                # Optimistic insert (the Fleet.submit comment): a
                # same-prefix follower in the same burst must route
                # here too, not wait for this request to finish.
                self.router.observe_digests(name, chain)
            body_out = payload
            if tiered:
                body_out = {k: v for k, v in payload.items()
                            if k != "_no_migrate"}
                body_out["migrate"] = True
            try:
                status, body, headers = await loop.run_in_executor(
                    self._proxy_pool, lambda: _http_json(
                        f"{name}/generate", method="POST",
                        body=body_out,
                        timeout=self.request_timeout_s))
            except Exception as e:   # noqa: BLE001 — transport failure
                self.router.update_replica(
                    name, ready=False,
                    reason=f"unreachable: {type(e).__name__}")
                tried.add(name)
                continue
            if status == 202 and isinstance(body.get("export"), dict):
                await self._migrate_leg(name, body, chain, writer)
                return
            if status == 503:
                # This replica is leaving (drain/quarantine/failure):
                # out of rotation now, re-route the request.
                self.router.update_replica(name, ready=False,
                                           reason="503 from replica")
                tried.add(name)
                continue
            body.setdefault("replica", name)
            extra_headers = {}
            if status == 429:
                # Aggregated hint: the retrying client will be routed
                # to the BEST replica, so the fleet-wide minimum is the
                # binding number, not the shedding replica's own.
                ready = self.router.ready_replicas()
                body["replica_set"] = len(ready)
                agg = self.retry_after_s()
                own = self._retry_by_replica.get(name)
                if own is not None:
                    agg = min(agg, own)
                extra_headers["Retry-After"] = max(1, math.ceil(agg))
            elif "Retry-After" in headers:
                extra_headers["Retry-After"] = headers["Retry-After"]
            if status == 200 and body.get("prefix_digest"):
                self.router.observe_digests(
                    name, list(body["prefix_digest"]))
            await self._respond(writer, status, body, extra_headers)
            return

    async def _migrate_leg(self, src: str, export_body: dict,
                           chain: List[str],
                           writer: asyncio.StreamWriter) -> None:
        """Leg 2 of the disaggregated flow: carry the 202 export from
        ``src`` (the prefill replica) to a decode-tier replica's
        /internal/adopt, then resolve the handoff at the source via
        /internal/export_done. Exactly-once: the source keeps the
        export parked until the callback — adopt success completes it,
        adopt exhaustion makes ok=false requeue it COLOCATED at the
        source, and the frontend answers the client from whichever leg
        actually finished."""
        from nanosandbox_tpu_torch.serve.router import NoReadyReplicaError

        loop = asyncio.get_running_loop()
        wire = export_body["export"]
        rid = export_body.get("id")
        # Payload size ~= the transferred chain: base64 is 4/3 overhead.
        nbytes = sum(len(leaf.get("data", "")) * 3 // 4
                     for leaf in wire.get("leaves", [])
                     if isinstance(leaf, dict))
        t0 = time.monotonic()
        tried = {src}
        while True:
            try:
                dec = self.router.route(chain, exclude=tried,
                                        failover=len(tried) > 1,
                                        phase="decode")
            except NoReadyReplicaError:
                break
            name = dec.replica
            try:
                status, body, headers = await loop.run_in_executor(
                    self._proxy_pool, lambda: _http_json(
                        f"{name}/internal/adopt", method="POST",
                        body=wire, timeout=self.request_timeout_s))
            except Exception as e:   # noqa: BLE001 — transport failure
                self.router.update_replica(
                    name, ready=False,
                    reason=f"unreachable: {type(e).__name__}")
                tried.add(name)
                continue
            if status in (200, 429):
                # Adopted: the decode tier resolved the request (a 429
                # is a post-adoption shed — still terminal THERE).
                # Confirm at the source so it releases the chain WITH
                # donation; best-effort — a lost callback self-heals by
                # the source's export timeout.
                try:
                    await loop.run_in_executor(
                        self._proxy_pool, lambda: _http_json(
                            f"{src}/internal/export_done", method="POST",
                            body={"rid": rid, "ok": True, "dst": name,
                                  "copied_blocks": int(
                                      wire.get("chain_blocks", 0)),
                                  "bytes": nbytes},
                            timeout=10.0))
                except Exception:    # noqa: BLE001 — callback is advisory
                    pass
                self._m_migrations.labels(outcome="ok").inc()
                self._m_migration_s.observe(time.monotonic() - t0)
                body.setdefault("replica", name)
                body["migrated_from"] = src
                if status == 200 and body.get("prefix_digest"):
                    self.router.observe_digests(
                        name, list(body["prefix_digest"]))
                fwd = ({"Retry-After": headers["Retry-After"]}
                       if "Retry-After" in headers else None)
                await self._respond(writer, status, body, fwd)
                return
            if status == 503 and body.get("retryable"):
                tried.add(name)      # backpressure: stays in rotation
                continue
            if status == 503:
                self.router.update_replica(name, ready=False,
                                           reason="503 from replica")
                tried.add(name)
                continue
            break                    # 400/unknown: fall back colocated
        # No decode replica could adopt: ok=false tells the source to
        # requeue colocated (same rid, pure prefix hit) and the call
        # blocks until that fallback finishes — the client still gets
        # exactly one answer.
        self._m_migrations.labels(outcome="fallback").inc()
        try:
            status, body, headers = await loop.run_in_executor(
                self._proxy_pool, lambda: _http_json(
                    f"{src}/internal/export_done", method="POST",
                    body={"rid": rid, "ok": False},
                    timeout=self.request_timeout_s))
        except Exception as e:       # noqa: BLE001 — source died too
            self._m_migrations.labels(outcome="failed").inc()
            await self._respond(
                writer, 502,
                {"error": f"migration fallback failed: {e!r}",
                 "id": rid})
            return
        body.setdefault("replica", src)
        fwd = ({"Retry-After": headers["Retry-After"]}
               if "Retry-After" in headers else None)
        await self._respond(writer, status, body, fwd)
        return

    # ---------------------------------------------------------- lifecycle
    async def _main(self) -> None:
        # Publish-once fields: written here on the router loop before the
        # _started barrier below, which start() waits on, so every other
        # thread (stop(), callers reading .port) sees the final values.
        # lockcheck: disable=unguarded-shared-write -- one assignment,
        # sequenced before the _started barrier that start() waits on.
        self._stopping = asyncio.Event()
        server = await asyncio.start_server(self._handle, self.host,
                                            self.port)
        # lockcheck: disable=unguarded-shared-write -- the bound port,
        # published before the same _started barrier.
        self.port = server.sockets[0].getsockname()[1]
        health = asyncio.create_task(self._health_loop())
        self._started.set()
        async with server:
            await self._stopping.wait()
        health.cancel()

    def start(self) -> "RouterFrontend":
        """Bind + serve on a daemon thread; returns self once the port
        is bound (tests pass port=0 and read .port)."""

        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(self._main())
            finally:
                self._loop.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="serve-router")
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError("router frontend failed to start")
        return self

    def stop(self) -> None:
        if self._loop is not None and self._stopping is not None:
            self._loop.call_soon_threadsafe(self._stopping.set)
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._proxy_pool.shutdown(wait=False)
