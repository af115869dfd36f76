"""Thin stdlib HTTP front end over the continuous-batching Engine.

The counterpart of nanosandbox_tpu/serve/http.py's EngineLoop and
make_server (the single-replica server), with the JAX server's routes,
request and response names:

    POST /generate  {"prompt": str | "prompt_tokens": [int], and any of
                     max_new_tokens, temperature, top_k, top_p, seed,
                     eos_id, deadline_s, slo_class, priority}
                     -> {"id", "tokens", "text", "finish_reason"}
                     (+ "prefix_digest" when prompt blocks were cached);
                     400 for a request the engine rejects (a bad
                     deadline or class included), 429 with Retry-After
                     for a request shed (deadline expired in the queue,
                     or the brownout ladder shedding its class), 503
                     when the engine loop is gone, the engine failed for
                     good, or the server is draining (with Retry-After
                     then), 504 on timeout. Every answer's status lands
                     in the flight recorder as an ``http`` event.
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
                    fragmentation and trie; the queue head first).

The Engine is single-threaded; EngineLoop is the ONE thread that steps
it, through an EngineSupervisor (serve/recovery.py) when it has one, as
the serve CLI does by default: a fault then recovers in place, and its
clients see only their (token-identical) answers. Handler threads
(ThreadingHTTPServer) hand submissions over through a lock-guarded inbox
and wait on a per-request Event, so N concurrent clients become N rows
of the same batched decode step; ``EngineLoop.call`` runs a function on
the loop thread between steps. The read-only views (/stats, /debug/*,
/trace) read the engine's host state from the handler thread.

Not ported here: /debug/prefix_summary, the disaggregation endpoints
(/internal/adopt, /internal/export_done) and the fleet's RouterFrontend.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
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


class EngineLoop(threading.Thread):
    """Background thread that owns the Engine: drains the submission
    inbox, steps while any request is in flight, sleeps otherwise.
    ``drain_now()`` turns draining on: requests in flight finish, new
    submissions get DrainingError (503 upstream) and readiness goes
    red."""

    def __init__(self, engine, supervisor=None):
        super().__init__(daemon=True, name="serve-engine-loop")
        self.engine = engine
        self.supervisor = supervisor
        self._stepper = supervisor if supervisor is not None else engine
        self._cond = threading.Condition()
        self._inbox: list[_Pending] = []
        self._by_rid: dict[int, _Pending] = {}
        self._taken: list[_Pending] = []     # being handed to the engine
        self._calls: list[tuple[Callable, _Pending]] = []
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
                    self._cond.wait()
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
            if res.finish_reason == "shed":
                # The engine is healthy; this request lost its place.
                # tokens are non-empty only for a preempted request shed
                # before its resume (what it had generated).
                cls = kwargs.get("slo_class", "default")
                self._gen_respond(429, {"error": "shed: deadline expired "
                                                 "in the queue (or "
                                                 "brownout shed)",
                                        "id": res.rid, "tokens": res.tokens,
                                        "finish_reason": "shed",
                                        "slo_class": cls}, rid=res.rid,
                                  headers={"Retry-After": retry_after(cls)})
                return
            if res.finish_reason == "failed":
                self._gen_respond(503, {"error": "generation failed (non-"
                                                 "finite logits, or the "
                                                 "engine failed for good)",
                                        "id": res.rid, "tokens": res.tokens,
                                        "finish_reason": "failed"},
                                  rid=res.rid)
                return
            body = {"id": res.rid, "tokens": res.tokens,
                    "text": (decode(list(res.prompt) + res.tokens)
                             if decode is not None else None),
                    "finish_reason": res.finish_reason}
            if res.prefix_digest:
                body["prefix_digest"] = list(res.prefix_digest)
            self._gen_respond(200, body, rid=res.rid)

    return ThreadingHTTPServer((host, port), Handler)
