"""Host-side telemetry of the port (counterpart of nanosandbox_tpu/obs).

So far the SLO ledger (slo.py) and the two watchdogs that recovery acts
on (flight.py). The metric registry, span tracer, flight recorder, the
other watchdogs and their dumps, and process vitals, with the Prometheus
mirror of the ledger, are a later slice of the port.
"""

from nanosandbox_tpu_torch.obs.flight import WatchdogPanel
from nanosandbox_tpu_torch.obs.slo import SLOLedger, validate_slo_class

__all__ = ["SLOLedger", "WatchdogPanel", "validate_slo_class"]
