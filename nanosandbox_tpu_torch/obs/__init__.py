"""Host-side telemetry of the port (counterpart of nanosandbox_tpu/obs).

So far the SLO ledger alone (slo.py). The metric registry, span tracer,
flight recorder and process vitals, with the Prometheus mirror of the
ledger, are a later slice of the port.
"""

from nanosandbox_tpu_torch.obs.slo import SLOLedger, validate_slo_class

__all__ = ["SLOLedger", "validate_slo_class"]
