"""Host-side telemetry of the port (counterpart of nanosandbox_tpu/obs).

Stdlib only, no torch import, nothing read from a device: every value
recorded is a host int, float or string the caller already holds.

  registry.py  MetricRegistry: named Counter / Gauge / Histogram families
               with labels, a JSON ``snapshot()`` and the Prometheus text
               exposition (byte-identical to the JAX package's).
  tracer.py    SpanTracer: begin/end spans in a bounded ring, request-id
               correlation, Chrome trace-event JSON export.
  flight.py    FlightRecorder (the per-request lifecycle ledger, JSONL)
               and WatchdogPanel (six anomaly detectors that dump the
               ledger, the span ring and the stats on a trip).
  slo.py       SLOLedger: per-class deadline attainment and goodput,
               mirrored into a registry.
  vitals.py    register_process_vitals: RSS, open fds, uptime, and the
               CUDA allocator's bytes, sampled per scrape.

The serving surface (serve/http.py) exposes all of it: ``GET /metrics``,
``GET /trace?rid=N``, ``GET /debug/requests|slots|kvpool|scheduler``
and ``POST /profile`` (a torch.profiler window over the live loop).
"""

from nanosandbox_tpu_torch.obs.flight import (TERMINAL_EVENTS, FlightRecorder,
                                              WatchdogPanel)
from nanosandbox_tpu_torch.obs.registry import (DEFAULT_BUCKETS, MetricFamily,
                                                MetricRegistry,
                                                global_registry,
                                                render_prometheus)
from nanosandbox_tpu_torch.obs.slo import SLOLedger, validate_slo_class
from nanosandbox_tpu_torch.obs.tracer import ENGINE_TRACK, Span, SpanTracer
from nanosandbox_tpu_torch.obs.vitals import register_process_vitals

__all__ = ["MetricRegistry", "MetricFamily", "SpanTracer", "Span",
           "global_registry", "render_prometheus", "DEFAULT_BUCKETS",
           "ENGINE_TRACK", "FlightRecorder", "WatchdogPanel",
           "TERMINAL_EVENTS", "SLOLedger", "validate_slo_class",
           "register_process_vitals"]
