"""lockcheck — concurrency static analysis for the serving host layer.

The port's copy of the JAX package's lockcheck, beside the host-sync
rule (``analysis/rules_sync.py``): the serve stack is a concurrent host
program — a stepping thread, stdlib HTTP handler threads, the asyncio
RouterFrontend and its executor pools, watchdog dumps, the export
reclaim and the disagg migration pump — and this pass checks its thread
discipline without running it. Pure ast + stdlib; no torch import.

Rules (see ``rules.py`` for semantics):

  * unguarded-shared-write  — attr written from ≥2 execution contexts
    with no common lock (and ``# guarded-by:`` enforcement)
  * lock-order-inversion    — cycle in the acquired-while-holding
    graph, or a violation of the committed tier ordering in
    ``nanosandbox_tpu_torch/analysis/lock_order.json``
  * blocking-under-lock     — host sync / device readback (torch's
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``synchronize``) / I/O / sleep / join inside a lock region
  * asyncio-blocking-call   — sync I/O in an ``async def`` not routed
    through ``run_in_executor``
  * leaked-acquire          — ``acquire()`` without with/try-finally

Run: ``python -m nanosandbox_tpu_torch.analysis lockcheck [--format=json]``.
Suppress with ``# lockcheck: disable=<rule> -- <why>`` (reason
mandatory). The runtime half is ``nanosandbox_tpu_torch.utils.schedcheck``:
a deterministic schedule-fuzz harness giving every static claim a
dynamic witness.
"""

from nanosandbox_tpu_torch.analysis.lockcheck.core import (  # noqa: F401
    DEFAULT_LOCK_ORDER, LockOrder, ModuleContext, Rule, all_rules,
    analyze_paths, analyze_source, load_lock_order, parse_suppressions,
    register, render_json, render_text)
from nanosandbox_tpu_torch.analysis.lockcheck.contexts import (  # noqa: F401
    ConcurrencyIndex)


def export_report_metrics(report: dict, registry) -> None:
    """Publish a lockcheck report into a MetricRegistry: the scrape
    surface obs_smoke asserts (lockcheck_findings_total by rule,
    lockcheck_files_scanned, lockcheck_suppressed_total)."""
    g = registry.gauge("lockcheck_files_scanned",
                       "Files scanned by the last lockcheck run.")
    g.set(report["summary"]["files_scanned"])
    s = registry.gauge("lockcheck_suppressed_total",
                       "Findings suppressed with a reasoned disable.")
    s.set(report["summary"]["suppressed"])
    c = registry.gauge("lockcheck_findings_total",
                       "Open lockcheck findings by rule.",
                       labelnames=("rule",))
    # Render a 0 sample even when clean so the scrape assertion has a
    # line to match (mirrors the shardcheck budget export).
    if not report["summary"]["by_rule"]:
        c.labels(rule="none").set(0)
    for rule, n in report["summary"]["by_rule"].items():
        c.labels(rule=rule).set(n)
