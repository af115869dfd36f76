"""Metric logging: the JAX package's MetricsWriter, warn_once and RingStat.

``<log_dir>/<run>/metrics.jsonl`` gets one header record
(``{"header": {...}, "time": t}``, written with the first scalars, so a
run that logs nothing leaves no file behind) and one record per
``log(step, scalars)`` (``{"step": n, "time": t, **scalars}``), the
JAX package's record format. With ``tensorboard=True`` every scalar that
``float()`` takes also goes, under its key as the tag, into a TensorBoard
event file beside it (utils/events.py), opened with the first scalars.

``RingStat`` is the bounded sample window the metric registry's
histograms keep (obs/registry.py).
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import deque
from typing import Any

from nanosandbox_tpu_torch.utils.events import EventFileWriter

_WARNED: set[str] = set()


def warn_once(key: str, msg: str) -> None:
    """Print msg to stderr the first time key is seen in the process.
    Every firing also counts in the process-global metric registry as
    ``warn_once_fired_total{key=...}``."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    # Lazy import: obs.registry imports RingStat from this module.
    from nanosandbox_tpu_torch.obs.registry import global_registry
    global_registry().counter(
        "warn_once_fired_total",
        "One-shot warn_once firings, by dedup key.",
        labelnames=("key",)).labels(key=key).inc()
    print(msg, file=sys.stderr, flush=True)


def reset_for_tests() -> None:
    """Clear the warn_once dedup set so a test can assert that a warning
    fires (once). The ``warn_once_fired_total`` counter is not reset: it
    is a monotonic process-lifetime ledger."""
    _WARNED.clear()


class RingStat:
    """Bounded ring of float samples with mean and percentile reads:
    O(1) memory over an unbounded stream, and percentiles of the recent
    window ("how slow is it now")."""

    def __init__(self, maxlen: int = 1024):
        self._buf: deque = deque(maxlen=maxlen)

    def record(self, x: float) -> None:
        self._buf.append(float(x))

    def __len__(self) -> int:
        return len(self._buf)

    def clear(self) -> None:
        self._buf.clear()

    def mean(self) -> float | None:
        # list(deque) is one C-level copy: reads may race the recording
        # thread (an HTTP handler against the engine loop).
        buf = list(self._buf)
        if not buf:
            return None
        return sum(buf) / len(buf)

    def percentiles(self, ps: tuple = (50, 90, 99)) -> dict | None:
        """{"p50": ..., "p90": ..., ...} over the window (nearest rank),
        or None before the first sample."""
        srt = sorted(self._buf)
        if not srt:
            return None
        n = len(srt)
        out = {}
        for p in ps:
            rank = max(1, -(-int(p) * n // 100))  # ceil(p/100 * n), >= 1
            out[f"p{int(p)}"] = srt[min(rank, n) - 1]
        return out


class MetricsWriter:
    def __init__(self, log_dir: str, run_name: str = "", enabled: bool = True,
                 tensorboard: bool = True):
        self.enabled = enabled
        self.jsonl = None
        self.tb = None
        self.tensorboard = tensorboard
        if not enabled:
            return
        run = run_name or time.strftime("%Y%m%d-%H%M%S")
        self.dir = os.path.join(log_dir, run)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.jsonl")
        self._pending_headers: list[dict[str, Any]] = []
        self._wrote_any = False

    def _write(self, rec: dict) -> None:
        if self.jsonl is None:
            self.jsonl = open(self.path, "a", buffering=1)
        self.jsonl.write(json.dumps(rec) + "\n")

    def write_header(self, meta: dict[str, Any]) -> None:
        """One provenance record (eval-batch policy, offset sampler, rng
        impl), deferred until the first log() unless scalars were
        already written."""
        if not self.enabled:
            return
        rec = {"header": meta, "time": time.time()}
        if self._wrote_any:
            self._write(rec)
        else:
            self._pending_headers.append(rec)

    def log(self, step: int, scalars: dict[str, Any]) -> None:
        if not self.enabled:
            return
        for rec in self._pending_headers:
            self._write(rec)
        self._pending_headers.clear()
        self._wrote_any = True
        self._write({"step": step, "time": time.time(), **scalars})
        if self.tensorboard:
            if self.tb is None:
                self.tb = EventFileWriter(self.dir)
            values = {}
            for k, v in scalars.items():
                try:
                    values[k] = float(v)
                except (TypeError, ValueError):
                    pass
            self.tb.add_scalars(step, values)

    def close(self) -> None:
        if self.jsonl is not None:
            self.jsonl.close()
            self.jsonl = None
        if self.tb is not None:
            self.tb.flush()
            self.tb.close()
            self.tb = None
