"""Minimal prometheus-style metrics registry with cluster-identity labels:
the port's copy of charon_tpu/utils/metrics.py.

Mirrors the reference's app/promauto (promauto.go): a process-wide registry
whose metrics all carry cluster-identity const labels (cluster_hash,
cluster_name, cluster_peer — set once at app wiring, reference
app/app.go:202-213); served in text exposition format by the monitoring API
and read in-process through snapshot() and snapshot_quantiles().
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Iterable


class _Metric:
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...]):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], float] = {}

    def labels(self, *values: str) -> tuple[str, ...]:
        if len(values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected {len(self.label_names)} labels")
        return tuple(str(v) for v in values)


class Counter(_Metric):
    kind = "counter"

    def inc(self, *label_values: str, amount: float = 1.0) -> None:
        key = self.labels(*label_values)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def value(self, *label_values: str) -> float:
        with self._lock:
            return self._children.get(self.labels(*label_values), 0.0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, *label_values: str) -> None:
        with self._lock:
            self._children[self.labels(*label_values)] = float(value)

    def inc(self, *label_values: str, amount: float = 1.0) -> None:
        key = self.labels(*label_values)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def value(self, *label_values: str) -> float:
        with self._lock:
            return self._children.get(self.labels(*label_values), 0.0)


_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str, label_names: tuple[str, ...],
                 buckets: Iterable[float] = _DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}

    def observe(self, value: float, *label_values: str) -> None:
        key = self.labels(*label_values)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            # bisect_left honours prometheus `le` (≤) semantics: a value
            # exactly on a bucket bound counts in THAT bucket, not the next.
            counts[bisect_left(self.buckets, value)] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def observe_time(self, *label_values: str):
        """Context manager timing the enclosed block into the histogram."""
        return _Timer(self, label_values)

    # back-compat alias (both names exist in the wild in this codebase)
    time = observe_time

    def quantile(self, q: float, *label_values: str) -> float:
        """Approximate quantile from bucket counts (upper bucket bound)."""
        key = self.labels(*label_values)
        with self._lock:
            counts = self._counts.get(key)
            if not counts:
                return 0.0
            total = sum(counts)
            target = q * total
            acc = 0
            for i, c in enumerate(counts):
                acc += c
                if acc >= target:
                    return self.buckets[i] if i < len(self.buckets) else float("inf")
            return float("inf")


class _Timer:
    def __init__(self, hist: Histogram, label_values: tuple[str, ...]):
        self._hist = hist
        self._labels = label_values
        self._t0 = 0.0

    def __enter__(self) -> "_Timer":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self._hist.observe(time.monotonic() - self._t0, *self._labels)


class Registry:
    """Metric registry with const labels (reference app/promauto/promauto.go)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self.const_labels: dict[str, str] = {}

    def set_const_labels(self, **labels: str) -> None:
        """Cluster identity labels (reference app/app.go:202-213)."""
        self.const_labels.update(labels)

    def counter(self, name: str, help_: str = "", labels: tuple[str, ...] = ()) -> Counter:
        return self._register(Counter(name, help_, labels))

    def gauge(self, name: str, help_: str = "", labels: tuple[str, ...] = ()) -> Gauge:
        return self._register(Gauge(name, help_, labels))

    def histogram(self, name: str, help_: str = "", labels: tuple[str, ...] = (),
                  buckets: Iterable[float] = _DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help_, labels, buckets))

    def _register(self, metric: _Metric):
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric):
                    raise ValueError(f"metric {metric.name} re-registered with different type")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def gather(self) -> dict[str, _Metric]:
        with self._lock:
            return dict(self._metrics)

    def snapshot(self, prefix: str = "") -> dict[str, float]:
        """Flat {name or name{label="v",...}: value} view of every counter
        and gauge whose name starts with `prefix` — the programmatic hook
        callers read (histograms expose
        via expose_text; their bucket vectors don't flatten to one value)."""
        out: dict[str, float] = {}
        for m in self.gather().values():
            if not m.name.startswith(prefix) or isinstance(m, Histogram):
                continue
            with m._lock:
                children = dict(m._children)
            if not children and not m.label_names:
                children = {(): 0.0}
            for key, value in children.items():
                lbl = ",".join(f'{n}="{v}"'
                               for n, v in zip(m.label_names, key))
                out[f"{m.name}{{{lbl}}}" if lbl else m.name] = value
        return out

    def snapshot_quantiles(self, prefix: str = "",
                           quantiles: tuple[float, ...] = (0.5, 0.99),
                           ) -> dict[str, dict[str, float]]:
        """Flat {name{label="v",...}: {"p50": v, "p99": v, "count": n,
        "sum": s}} view of every histogram whose name starts with `prefix` —
        the programmatic hook callers read latency
        percentiles through (snapshot() covers counters/gauges only)."""
        out: dict[str, dict[str, float]] = {}
        for m in self.gather().values():
            if not m.name.startswith(prefix) or not isinstance(m, Histogram):
                continue
            with m._lock:
                keys = list(m._counts)
                sums = dict(m._sums)
                counts = {k: sum(m._counts[k]) for k in keys}
            for key in keys:
                lbl = ",".join(f'{n}="{v}"'
                               for n, v in zip(m.label_names, key))
                stats: dict[str, float] = {
                    "count": float(counts[key]),
                    "sum": sums.get(key, 0.0),
                }
                for q in quantiles:
                    stats[f"p{int(q * 100)}"] = m.quantile(q, *key)
                out[f"{m.name}{{{lbl}}}" if lbl else m.name] = stats
        return out

    def expose_text(self) -> str:
        """Prometheus text exposition format."""
        const_parts = [f'{k}="{v}"' for k, v in sorted(self.const_labels.items())]

        def labelset(m: _Metric, key: tuple[str, ...], *extra: str) -> str:
            parts = const_parts + [
                f'{n}="{v}"' for n, v in zip(m.label_names, key)] + list(extra)
            return ",".join(parts)

        lines: list[str] = []
        for m in self.gather().values():
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                with m._lock:
                    for key, counts in m._counts.items():
                        acc = 0
                        for i, ub in enumerate(m.buckets):
                            acc += counts[i]
                            le = f'le="{ub}"'
                            lines.append(f'{m.name}_bucket{{{labelset(m, key, le)}}} {acc}')
                        acc += counts[-1]
                        le = 'le="+Inf"'
                        lines.append(f'{m.name}_bucket{{{labelset(m, key, le)}}} {acc}')
                        lines.append(f"{m.name}_sum{{{labelset(m, key)}}} {m._sums.get(key, 0.0)}")
                        lines.append(f"{m.name}_count{{{labelset(m, key)}}} {acc}")
            else:
                with m._lock:
                    children = dict(m._children)
                if not children and not m.label_names:
                    children = {(): 0.0}
                for key, value in children.items():
                    lbl = labelset(m, key)
                    lines.append(f"{m.name}{{{lbl}}} {value}" if lbl else f"{m.name} {value}")
        return "\n".join(lines) + "\n"


# Process-wide default registry (reference promauto's global registry).
default_registry = Registry()
counter = default_registry.counter
gauge = default_registry.gauge
histogram = default_registry.histogram
snapshot_quantiles = default_registry.snapshot_quantiles
