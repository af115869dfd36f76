"""Thin stdlib HTTP front end over the continuous-batching Engine.

The counterpart of nanosandbox_tpu/serve/http.py's EngineLoop and
make_server, with the JAX server's request and response names:

    POST /generate  {"prompt": str | "prompt_tokens": [int], and any of
                     max_new_tokens, temperature, top_k, top_p, seed,
                     eos_id, deadline_s, slo_class, priority}
                     -> {"id", "tokens", "text", "finish_reason"}
                     (+ "prefix_digest" when prompt blocks were cached);
                     400 for a request the engine rejects (a bad
                     deadline or class included), 429 with Retry-After
                     for a request shed (deadline expired in the queue,
                     or the brownout ladder shedding its class), 503
                     when the engine loop is gone, 504 on timeout.
                     503 when the engine loop is gone or the engine
                     failed for good (with Retry-After then).
    GET  /healthz   liveness: {"ok": true} while the engine loop runs
                    and the engine has not failed for good, else 503.
    GET  /healthz?ready=1  readiness: {"ok", "ready"}; also false (503,
                    with "reason" and Retry-After) while the engine is
                    quarantined for recovery or has failed.
    GET  /stats     engine counters: tokens, steps, prefix hits, TTFT /
                    TPOT percentiles, decode tokens/s; sheds,
                    preemptions, the prefill chunk, the brownout level
                    and the SLO ledger; spec acceptance, recovery, the
                    fault plan and the watchdogs; the loop's supervisor.

The Engine is single-threaded; EngineLoop is the ONE thread that touches
it, stepping it through an EngineSupervisor (serve/recovery.py) when it
has one, as the serve CLI does by default: a fault then recovers in
place, and its clients see only their (token-identical) answers.
Handler threads (ThreadingHTTPServer) hand submissions over through a
lock-guarded inbox and wait on a per-request Event, so N concurrent
clients become N rows of the same batched decode step.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlsplit

from nanosandbox_tpu_torch.serve.engine import EngineFailedError


class _Pending:
    def __init__(self, kwargs: dict):
        self.kwargs = kwargs
        self.done = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None


class EngineLoop(threading.Thread):
    """Background thread that owns the Engine: drains the submission
    inbox, steps while any request is in flight, sleeps otherwise."""

    def __init__(self, engine, supervisor=None):
        super().__init__(daemon=True, name="serve-engine-loop")
        self.engine = engine
        self.supervisor = supervisor
        self._stepper = supervisor if supervisor is not None else engine
        self._cond = threading.Condition()
        self._inbox: list[_Pending] = []
        self._by_rid: dict[int, _Pending] = {}
        self._taken: list[_Pending] = []     # being handed to the engine
        self._stopping = False
        # Set when the loop dies on an engine error: /healthz goes red.
        self.dead: Optional[str] = None

    def submit(self, **kwargs) -> _Pending:
        """Thread-safe: queue a request for the loop thread."""
        p = _Pending(kwargs)
        with self._cond:
            if self.dead is not None:
                p.error = RuntimeError(f"engine loop died: {self.dead}")
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

    def stop(self) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify()

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
        if self.engine.quarantined:
            return False, f"quarantined: {self.engine.quarantine_cause}"
        sup = self.supervisor
        if sup is not None and sup.state != "ok":
            return False, f"supervisor state {sup.state}"
        return True, "ok"

    def stats(self) -> dict:
        with self._cond:
            out = {"inbox": len(self._inbox), "waiting": len(self._by_rid),
                   "dead": self.dead}
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
                       and not self.engine.has_work()):
                    self._cond.wait()
                if self._stopping:
                    self._fail_all(RuntimeError("server shutting down"))
                    return
                self._taken, self._inbox = self._inbox, []
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
        for p in (*self._inbox, *self._taken, *self._by_rid.values()):
            if not p.done.is_set():
                p.error = err
                p.done.set()
        self._inbox, self._taken, self._by_rid = [], [], {}


def make_server(host: str, port: int, loop: EngineLoop,
                encode: Optional[Callable[[str], list]] = None,
                decode: Optional[Callable[[list], str]] = None,
                request_timeout: float = 300.0) -> ThreadingHTTPServer:
    """HTTP server bound to an EngineLoop (routes in the module
    docstring). Without a tokenizer (``encode``/``decode`` None), text
    prompts are a 400 and responses carry "text": null; prompt_tokens
    requests need none."""

    def retry_after(slo_class: Optional[str]) -> int:
        """Whole seconds for a 429's Retry-After, scaled by the queue
        mass ahead of the requester's class (Engine.retry_after_s)."""
        return max(1, math.ceil(
            loop.engine.retry_after_s(slo_class=slo_class)))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # stdout stays quiet
            pass

        def _json(self, code: int, obj: dict,
                  headers: Optional[dict] = None) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            url = urlsplit(self.path)
            path = url.path
            ready_q = parse_qs(url.query).get("ready", ["0"])[0]
            if path == "/healthz" and ready_q not in ("0", "", "false"):
                ready, reason = loop.is_ready()
                body = {"ok": ready, "ready": ready}
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
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
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
                self._json(400, {"error": f"bad request: {e!r}"})
                return
            try:
                res = loop.generate(timeout=request_timeout, **kwargs)
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            except TimeoutError as e:
                self._json(504, {"error": str(e)})
                return
            except EngineFailedError as e:
                self._json(503, {"error": str(e)},
                           headers={"Retry-After": retry_after(None)})
                return
            except RuntimeError as e:
                self._json(503, {"error": str(e)})
                return
            if res.finish_reason == "shed":
                # The engine is healthy; this request lost its place.
                # tokens are non-empty only for a preempted request shed
                # before its resume (what it had generated).
                cls = kwargs.get("slo_class", "default")
                self._json(429, {"error": "shed: deadline expired in the "
                                          "queue (or brownout shed)",
                                 "id": res.rid, "tokens": res.tokens,
                                 "finish_reason": "shed",
                                 "slo_class": cls},
                           headers={"Retry-After": retry_after(cls)})
                return
            if res.finish_reason == "failed":
                self._json(503, {"error": "generation failed (non-finite "
                                          "logits, or the engine failed "
                                          "for good)", "id": res.rid,
                                 "tokens": res.tokens,
                                 "finish_reason": "failed"})
                return
            body = {"id": res.rid, "tokens": res.tokens,
                    "text": (decode(list(res.prompt) + res.tokens)
                             if decode is not None else None),
                    "finish_reason": res.finish_reason}
            if res.prefix_digest:
                body["prefix_digest"] = list(res.prefix_digest)
            self._json(200, body)

    return ThreadingHTTPServer((host, port), Handler)
