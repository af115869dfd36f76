"""Process vitals for /metrics: host health next to engine counters.

The counterpart of nanosandbox_tpu/obs/vitals.py. A scrape that shows
TTFT p99 climbing but nothing about why is half a dashboard: RSS creep,
fd exhaustion and device-memory growth are the classic serving slow
deaths, and none of them live in an engine counter.
``register_process_vitals`` adds collection-time gauges to a registry
(the process-global one by default):

  process_resident_memory_bytes   current RSS (/proc/self/statm;
                                  ru_maxrss high-water fallback)
  process_open_fds                /proc/self/fd count
  process_start_time_seconds      unix time this module was imported
  process_uptime_seconds          seconds since then
  torch_cuda_allocated_bytes      torch.cuda.memory_allocated()
  torch_cuda_max_allocated_bytes  torch.cuda.max_memory_allocated()

The last two take the place of JAX's live-buffer gauges
(jax_live_buffer_bytes / _count): PyTorch's caching allocator keeps the
byte counts, not a list of live arrays. Everything is sampled at
collection time (per scrape), so it costs the hot loop nothing. The
module imports no torch: the CUDA gauges read ``torch.cuda`` only when
torch is already imported and CUDA is already initialised (a process
that never touched the card must not create a context because
Prometheus scraped it); both reads are allocator bookkeeping on the
host, no device sync.
"""

from __future__ import annotations

import os
import resource
import sys
import time
from typing import Optional

from nanosandbox_tpu_torch.obs.registry import MetricRegistry, global_registry

_START_WALL = time.time()


def _rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * (resource.getpagesize())
    except (OSError, ValueError, IndexError):
        pass
    # Portable fallback: the high-water mark (KB on Linux, bytes on
    # macOS; Linux's KB normalised).
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    if rss <= 0:
        return None
    return rss * 1024 if sys.platform.startswith("linux") else rss


def _open_fds() -> Optional[int]:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


def register_process_vitals(registry: Optional[MetricRegistry] = None,
                            ) -> MetricRegistry:
    """Idempotently add the vitals gauges and collector to ``registry``
    (default: the process-global registry). Returns the registry."""
    reg = registry if registry is not None else global_registry()
    # Once per registry object (a flag on the instance, not an id() set:
    # a recycled address must not skip a fresh registry); registering
    # twice would double-add the collector.
    if getattr(reg, "_vitals_registered", False):
        return reg
    reg._vitals_registered = True
    g_rss = reg.gauge("process_resident_memory_bytes",
                      "Resident set size of this process.", unit="bytes")
    g_fds = reg.gauge("process_open_fds",
                      "Open file descriptors of this process.")
    g_start = reg.gauge("process_start_time_seconds",
                        "Unix time vitals were first registered.",
                        unit="seconds")
    g_uptime = reg.gauge("process_uptime_seconds",
                         "Seconds since vitals were first registered.",
                         unit="seconds")
    g_cuda = reg.gauge(
        "torch_cuda_allocated_bytes",
        "Bytes held by tensors in torch's CUDA caching allocator at "
        "collection time.", unit="bytes")
    g_cuda_max = reg.gauge(
        "torch_cuda_max_allocated_bytes",
        "High-water mark of torch's CUDA tensor bytes.", unit="bytes")

    def collect() -> None:
        rss = _rss_bytes()
        if rss is not None:
            g_rss.set(rss)
        fds = _open_fds()
        if fds is not None:
            g_fds.set(fds)
        g_start.set(_START_WALL)
        g_uptime.set(time.time() - _START_WALL)
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            g_cuda.set(float(torch.cuda.memory_allocated()))
            g_cuda_max.set(float(torch.cuda.max_memory_allocated()))
    reg.add_collector(collect)
    return reg
