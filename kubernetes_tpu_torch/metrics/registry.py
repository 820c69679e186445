"""Prometheus-style metrics: counters, gauges and histograms with label
vectors, a registry with the Prometheus text exposition, and the
bucket-interpolated quantile the SLO engine and the row summaries read.
The same series, buckets and exposition text as the JAX package's
``metrics/registry.py``."""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

LabelValues = Tuple[str, ...]


class _Metric:
    def __init__(self, name: str, help_text: str,
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()


class Counter(_Metric):
    TYPE = "counter"

    def __init__(self, name, help_text, label_names=()):
        super().__init__(name, help_text, label_names)
        self._values: Dict[LabelValues, float] = {}

    def inc(self, *label_values: str, amount: float = 1.0) -> None:
        with self._lock:
            key = tuple(label_values)
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, *label_values: str) -> float:
        with self._lock:
            return self._values.get(tuple(label_values), 0.0)

    def collect(self):
        with self._lock:
            return [(self.name, k, v) for k, v in self._values.items()]


class Gauge(_Metric):
    TYPE = "gauge"

    def __init__(self, name, help_text, label_names=()):
        super().__init__(name, help_text, label_names)
        self._values: Dict[LabelValues, float] = {}

    def set(self, value: float, *label_values: str) -> None:
        with self._lock:
            self._values[tuple(label_values)] = value

    def inc(self, *label_values: str, amount: float = 1.0) -> None:
        with self._lock:
            key = tuple(label_values)
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, *label_values: str) -> None:
        self.inc(*label_values, amount=-1.0)

    def get(self, *label_values: str) -> float:
        with self._lock:
            return self._values.get(tuple(label_values), 0.0)

    def collect(self):
        with self._lock:
            return [(self.name, k, v) for k, v in self._values.items()]


DEFAULT_BUCKETS = (
    0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 3.0,
    5.0, 7.5, 10.0, 15.0, 20.0, 30.0, 40.0, 50.0,
)


class Histogram(_Metric):
    TYPE = "histogram"

    def __init__(self, name, help_text, label_names=(),
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_text, label_names)
        self.buckets = tuple(sorted(buckets))
        # label values -> [bucket counts (+Inf last), sum, count]
        self._series: Dict[LabelValues, list] = {}

    def _get_series(self, key: LabelValues) -> list:
        series = self._series.get(key)
        if series is None:
            series = [[0] * (len(self.buckets) + 1), 0.0, 0]
            self._series[key] = series
        return series

    def observe(self, value: float, *label_values: str) -> None:
        with self._lock:
            series = self._get_series(label_values)
            series[0][bisect.bisect_left(self.buckets, value)] += 1
            series[1] += value
            series[2] += 1

    def observe_many(self, values, *label_values: str) -> None:
        """Observe a batch under one lock (the bulk commit's per-pod
        latencies)."""
        if not values:
            return
        with self._lock:
            series = self._get_series(label_values)
            counts = series[0]
            buckets = self.buckets
            total = 0.0
            for v in values:
                counts[bisect.bisect_left(buckets, v)] += 1
                total += v
            series[1] += total
            series[2] += len(values)

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    def bucket_counts(self, *label_values: str) -> List[int]:
        """One series' per-bucket counts, the +Inf overflow last."""
        with self._lock:
            series = self._series.get(tuple(label_values))
            return list(series[0]) if series else []

    def count(self, *label_values: str) -> int:
        with self._lock:
            series = self._series.get(tuple(label_values))
            return series[2] if series else 0

    def sum(self, *label_values: str) -> float:
        with self._lock:
            series = self._series.get(tuple(label_values))
            return series[1] if series else 0.0

    def quantile(self, q: float, *label_values: str) -> float:
        """Bucket-interpolated quantile (Prometheus histogram_quantile:
        linear within the target bucket)."""
        with self._lock:
            series = self._series.get(tuple(label_values))
            counts = list(series[0]) if series else None
        if not counts:
            return 0.0
        return quantile_from_counts(counts, self.buckets, q)

    def collect(self):
        with self._lock:
            return [(self.name, k, series[1], series[2])
                    for k, series in self._series.items()]

    def collect_full(self):
        """Per series: (labels, bucket counts, sum, count)."""
        with self._lock:
            return [(k, list(series[0]), series[1], series[2])
                    for k, series in self._series.items()]


def quantile_from_counts(counts: Sequence[int], edges: Sequence[float],
                         q: float) -> float:
    """Bucket-interpolated quantile over a raw count vector (a windowed
    or summed one that no live series holds)."""
    total = sum(counts)
    if not counts or total == 0:
        return 0.0
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        prev_cum = cum
        cum += c
        if cum >= target:
            if i >= len(edges):
                return edges[-1] if edges else 0.0
            lo = edges[i - 1] if i > 0 else 0.0
            hi = edges[i]
            if c == 0:
                return hi
            return lo + (hi - lo) * (target - prev_cum) / c
    return edges[-1] if edges else 0.0


class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            self._metrics[metric.name] = metric
            return metric

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def all_metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def expose(self) -> str:
        """Prometheus text exposition; a histogram renders its cumulative
        ``_bucket{le=...}`` lines (``+Inf`` included), ``_sum`` and
        ``_count``."""
        lines = []
        for m in self.all_metrics():
            lines.append(f"# HELP {m.name} {_esc_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.TYPE}")
            if isinstance(m, Histogram):
                edges = [_fmt_float(b) for b in m.buckets] + ["+Inf"]
                for labels, counts, total_sum, total in m.collect_full():
                    cum = 0
                    for edge, c in zip(edges, counts):
                        cum += c
                        label_str = _fmt_labels(m.label_names + ("le",),
                                                labels + (edge,))
                        lines.append(f"{m.name}_bucket{label_str} {cum}")
                    label_str = _fmt_labels(m.label_names, labels)
                    lines.append(f"{m.name}_sum{label_str} {total_sum}")
                    lines.append(f"{m.name}_count{label_str} {total}")
            else:
                for name, labels, value in m.collect():
                    lines.append(
                        f"{name}{_fmt_labels(m.label_names, labels)} {value}")
        return "\n".join(lines) + "\n"


def _fmt_float(v: float) -> str:
    """An integral bucket edge drops its ``.0`` (``le="1"``)."""
    return str(int(v)) if float(v) == int(v) else repr(float(v))


def _esc_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(names, values) -> str:
    if not values:
        return ""
    pairs = ",".join(f'{n}="{_esc_label(v)}"' for n, v in zip(names, values))
    return "{" + pairs + "}"


# get-or-register: components that share a registry share their series
def counter(registry: MetricsRegistry, name: str, help_text: str,
            labels=()) -> Counter:
    existing = registry.get(name)
    if isinstance(existing, Counter):
        return existing
    return registry.register(Counter(name, help_text, labels))


def gauge(registry: MetricsRegistry, name: str, help_text: str,
          labels=()) -> Gauge:
    existing = registry.get(name)
    if isinstance(existing, Gauge):
        return existing
    return registry.register(Gauge(name, help_text, labels))


def histogram(registry: MetricsRegistry, name: str, help_text: str,
              labels=(), buckets=DEFAULT_BUCKETS) -> Histogram:
    existing = registry.get(name)
    if isinstance(existing, Histogram):
        return existing
    return registry.register(Histogram(name, help_text, labels,
                                       buckets=buckets))
