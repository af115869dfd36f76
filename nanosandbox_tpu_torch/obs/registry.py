"""Process-wide metric registry: named Counter/Gauge/Histogram families.

This package's own copy of nanosandbox_tpu/obs/registry.py, with its
names, semantics and text format (the same sequence of operations
renders byte-identical Prometheus text on both):

  * a **family** is a named metric (``serve_ttft_seconds``) of one kind
    (counter | gauge | histogram) with a fixed tuple of label names;
    ``family.labels(slot="3")`` returns the child series for one label
    combination, created on first touch;
  * ``snapshot()`` is the JSON view;
  * ``prometheus_text()`` is the text exposition format a Prometheus
    scrape consumes (``GET /metrics`` in serve/http.py).

Hot-loop cost is zero by design: counters that mirror engine state are
not incremented per token. **Collectors** (callbacks run at collection
time, i.e. per scrape) copy the engine's plain-int counters into the
families. Only histograms observe per event, and an observe is a deque
append and one bisect. Recorded values are host ints and floats the
caller already holds: nothing here reads a device tensor, and the
module imports no torch.

Histograms are two views of the same stream: the bounded ``RingStat``
window (recent percentiles: "how slow is it now") and fixed-bucket
cumulative counts, sum and count (what Prometheus wants for rate() and
histogram_quantile over all time). The exposition renders both: the
histogram proper, and a ``<name>_window`` summary with ``quantile``
labels from the ring.
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from nanosandbox_tpu_torch.utils.metrics import RingStat

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency-shaped default buckets (seconds): spans ~1ms..10s, the serving
# TTFT/TPOT range from a CPU tiny model to a GPU server.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render as ints so the
    golden-format test (and a human) reads `3`, not `3.0`."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _labelstr(names: Tuple[str, ...], values: Tuple[str, ...],
              extra: str = "") -> str:
    parts = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Child:
    """One labeled series of a family. Created by ``family.labels()``;
    the label-less family delegates to its own ``()`` child."""

    __slots__ = ("_family", "_values", "_value", "_lock",
                 "_ring", "_bucket_counts", "_sum", "_count")

    def __init__(self, family: "MetricFamily", values: Tuple[str, ...]):
        self._family = family
        self._values = values
        self._lock = threading.Lock()
        self._value: Optional[float] = 0.0 if family.kind == "counter" \
            else None
        if family.kind == "histogram":
            self._ring = RingStat(family.window)
            self._bucket_counts = [0] * len(family.buckets)
            self._sum = 0.0
            self._count = 0

    # -- counter ----------------------------------------------------------
    def inc(self, amount: float = 1.0) -> None:
        if self._family.kind != "counter":
            raise TypeError(f"{self._family.name} is {self._family.kind}, "
                            "not counter")
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    def _set_total(self, value: float) -> None:
        """Collector backdoor: mirror an externally-owned monotonic
        counter (the engine's plain ints) into this
        series at collection time. Not part of the recording API."""
        with self._lock:
            self._value = float(value)

    # -- gauge ------------------------------------------------------------
    def set(self, value: float) -> None:
        if self._family.kind != "gauge":
            raise TypeError(f"{self._family.name} is {self._family.kind}, "
                            "not gauge")
        with self._lock:
            self._value = float(value)

    # -- histogram --------------------------------------------------------
    def observe(self, value: float) -> None:
        if self._family.kind != "histogram":
            raise TypeError(f"{self._family.name} is {self._family.kind}, "
                            "not histogram")
        v = float(value)
        with self._lock:
            self._ring.record(v)
            i = bisect_left(self._family.buckets, v)
            if i < len(self._bucket_counts):
                self._bucket_counts[i] += 1
            self._sum += v
            self._count += 1

    def hist_state(self) -> Tuple[List[int], float, int]:
        """Coherent (bucket_counts, sum, count) copy under the same lock
        observe() writes under — a render interleaving with an observe
        must never emit a finite bucket greater than +Inf/_count (a
        non-monotonic histogram poisons histogram_quantile())."""
        with self._lock:
            return list(self._bucket_counts), self._sum, self._count

    # RingStat-compatible window reads: Engine.stats()'s percentile
    # dicts are built from these.
    def mean(self) -> Optional[float]:
        return self._ring.mean()

    def percentiles(self, ps: tuple = (50, 90, 99)) -> Optional[dict]:
        return self._ring.percentiles(ps)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def value(self) -> Optional[float]:
        return self._value

    def reset(self) -> None:
        """Clear this series (benchmarks reset between warmup and the
        timed window; production scrapes never call this)."""
        with self._lock:
            if self._family.kind == "histogram":
                self._ring.clear()
                self._bucket_counts = [0] * len(self._family.buckets)
                self._sum = 0.0
                self._count = 0
            elif self._family.kind == "counter":
                self._value = 0.0
            else:
                self._value = None


class MetricFamily:
    """A named metric with a fixed label-name tuple; children per label
    value combination. Label-less use (``family.inc()``) routes to the
    ``()`` child so callers never see the two-level structure unless
    they label."""

    def __init__(self, name: str, kind: str, help: str = "",
                 unit: str = "", labelnames: Tuple[str, ...] = (),
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                 window: int = 1024):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        if kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"invalid metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.unit = unit
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.window = window
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> Tuple[str, ...]:
        if tuple(sorted(labels)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def labels(self, **labels: object) -> _Child:
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(self, key)
            return child

    def peek(self, **labels: object) -> Optional[_Child]:
        """The child for this label combination IF it exists — never
        creates one. The read-side twin of labels(): Engine.stats()
        reads series this way so a feature that never recorded (prefix
        cache off, spec off) never mints an empty series that the
        exposition would then render as a placeholder (the /metrics
        label-hygiene rule, pinned by test)."""
        key = self._key(labels)
        with self._lock:
            return self._children.get(key)

    def _default(self) -> _Child:
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; use .labels()")
        return self.labels()

    # label-less conveniences: WRITES create the () child; READS peek
    # (a family nothing ever recorded to must stay series-less so the
    # exposition skips it — reading stats() is not recording).
    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def _set_total(self, value: float) -> None:
        self._default()._set_total(value)

    def set(self, value: float) -> None:
        self._default().set(value)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def mean(self):
        child = self.peek()
        return None if child is None else child.mean()

    def percentiles(self, ps: tuple = (50, 90, 99)):
        child = self.peek()
        return None if child is None else child.percentiles(ps)

    @property
    def value(self):
        child = self.peek()
        return None if child is None else child.value

    def series(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())

    def reset(self) -> None:
        for _, child in self.series():
            child.reset()


class MetricRegistry:
    """A namespace of families plus collection-time callbacks.

    Re-registering a name returns the existing family (process-wide
    semantics: any module may say ``registry.counter("x", ...)`` and get
    the shared series) — but a kind or label mismatch is a programming
    error and raises rather than silently forking the metric.
    """

    def __init__(self):
        self._families: Dict[str, MetricFamily] = {}
        self._collectors: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    # -- family constructors ---------------------------------------------
    def _family(self, name: str, kind: str, help: str, unit: str,
                labelnames: Tuple[str, ...], **kw) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, not "
                        f"{kind}{tuple(labelnames)}")
                return fam
            fam = MetricFamily(name, kind, help=help, unit=unit,
                               labelnames=tuple(labelnames), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", unit: str = "",
                labelnames: Iterable[str] = ()) -> MetricFamily:
        return self._family(name, "counter", help, unit, tuple(labelnames))

    def gauge(self, name: str, help: str = "", unit: str = "",
              labelnames: Iterable[str] = ()) -> MetricFamily:
        return self._family(name, "gauge", help, unit, tuple(labelnames))

    def histogram(self, name: str, help: str = "", unit: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  window: int = 1024) -> MetricFamily:
        return self._family(name, "histogram", help, unit,
                            tuple(labelnames), buckets=buckets,
                            window=window)

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Register a collection-time callback (runs per snapshot/scrape,
        NEVER in a hot loop) that copies externally-owned state (the
        engine's plain-int counters) into families."""
        with self._lock:
            self._collectors.append(fn)

    def collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn()

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    # -- views ------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-ready view of every family after running collectors."""
        self.collect()
        out: dict = {}
        for fam in self.families():
            series = []
            for values, child in fam.series():
                labels = dict(zip(fam.labelnames, values))
                if fam.kind == "histogram":
                    _, hsum, hcount = child.hist_state()
                    series.append({
                        "labels": labels,
                        "count": hcount,
                        "sum": hsum,
                        "mean": child.mean(),
                        "percentiles": child.percentiles((50, 90, 99)),
                    })
                else:
                    if child.value is None:
                        continue  # unset gauge: no sample
                    series.append({"labels": labels, "value": child.value})
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "unit": fam.unit, "series": series}
        return out

    def prometheus_text(self) -> str:
        self.collect()
        return render_prometheus_families(self.families())


def render_prometheus_families(families: Iterable[MetricFamily]) -> str:
    """Text exposition format (version 0.0.4) over already-collected
    families — the shared renderer behind ``registry.prometheus_text()``
    and serve/http.py's multi-registry ``GET /metrics``."""
    lines: List[str] = []
    for fam in families:
        series = fam.series()
        if not series:
            continue
        if all(fam.kind != "histogram" and c.value is None
               for _, c in series):
            continue
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        if fam.kind == "histogram":
            hist_states = {}
            for values, child in series:
                buckets, hsum, hcount = child.hist_state()
                hist_states[values] = (hsum, hcount)
                cum = 0
                for le, n in zip(fam.buckets, buckets):
                    cum += n
                    lab = _labelstr(fam.labelnames, values,
                                    f'le="{_fmt(le)}"')
                    lines.append(f"{fam.name}_bucket{lab} {cum}")
                lab = _labelstr(fam.labelnames, values, 'le="+Inf"')
                lines.append(f"{fam.name}_bucket{lab} {hcount}")
                lab = _labelstr(fam.labelnames, values)
                lines.append(f"{fam.name}_sum{lab} {_fmt(hsum)}")
                lines.append(f"{fam.name}_count{lab} {hcount}")
            # The recent-window percentile view, as its own summary
            # family: histogram_quantile() needs rate() over scrapes,
            # but an operator mid-incident (or the CI smoke) wants the
            # current p50/p90/p99 directly.
            wname = f"{fam.name}_window"
            lines.append(f"# TYPE {wname} summary")
            for values, child in series:
                pct = child.percentiles((50, 90, 99)) or {}
                for p, q in (("p50", "0.5"), ("p90", "0.9"),
                             ("p99", "0.99")):
                    if p in pct:
                        lab = _labelstr(fam.labelnames, values,
                                        f'quantile="{q}"')
                        lines.append(f"{wname}{lab} {_fmt(pct[p])}")
                hsum, hcount = hist_states[values]
                lab = _labelstr(fam.labelnames, values)
                lines.append(f"{wname}_sum{lab} {_fmt(hsum)}")
                lines.append(f"{wname}_count{lab} {hcount}")
        else:
            for values, child in series:
                if child.value is None:
                    continue
                lab = _labelstr(fam.labelnames, values)
                lines.append(f"{fam.name}{lab} {_fmt(child.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def render_prometheus(*registries: MetricRegistry) -> str:
    """One exposition over several registries (engine + process-global +
    loop in serve/http.py). Duplicate family names across registries
    would emit conflicting TYPE lines, so they raise loudly here instead
    of producing a page Prometheus rejects at scrape time."""
    fams: List[MetricFamily] = []
    seen: Dict[str, MetricFamily] = {}
    for reg in registries:
        reg.collect()
        for fam in reg.families():
            if fam.name in seen:
                raise ValueError(
                    f"metric {fam.name!r} exported by two registries")
            seen[fam.name] = fam
            fams.append(fam)
    return render_prometheus_families(fams)


# Process-global registry: the home of metrics with no natural owner
# object (warn_once firings, process vitals). Engines and Trainers own
# per-instance registries (tests spin up many) and serve/http.py renders
# both on /metrics.
_GLOBAL = MetricRegistry()


def global_registry() -> MetricRegistry:
    return _GLOBAL
