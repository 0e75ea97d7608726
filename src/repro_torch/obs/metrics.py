"""Metric instruments (copy of ``repro.obs.metrics``): counters, gauges,
histograms with interpolated quantiles, and the registry that names them.

The histogram quantile is the shared percentile helper: percentiles go
through :func:`quantile` (numpy's "linear" method) rather than an index into
a sorted list (``lat[len(lat)//2]`` is not a median on
even-length samples; the interpolated estimator is exact on them).
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Sequence, Tuple

# Raw samples retained per histogram for quantile estimation; past the cap
# count/sum/min/max stay exact and quantiles are computed over the retained
# prefix (host-side run telemetry stays far below this in practice).
HIST_MAX_SAMPLES = 65536

LabelItems = Tuple[Tuple[str, str], ...]


def quantile(values: Sequence[float], q: float) -> float:
    """Interpolated quantile of ``values`` (numpy's "linear" method).

    ``q`` in [0, 1].  Empty input returns 0.0; a single sample is every
    quantile of itself.  ``quantile(x, 0.5)`` of an even-length sample is
    the mean of the two middle order statistics — the textbook median.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile q must be in [0, 1], got {q}")
    vals = sorted(float(v) for v in values)
    if not vals:
        return 0.0
    pos = q * (len(vals) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


class Counter:
    """Monotone event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Sample accumulator with interpolated percentile estimation."""

    __slots__ = ("samples", "count", "sum", "min", "max")

    def __init__(self):
        self.samples: List[float] = []
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self.samples) < HIST_MAX_SAMPLES:
            self.samples.append(v)

    def quantile(self, q: float) -> float:
        return quantile(self.samples, q)

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Named, labeled instruments of one telemetry run.

    ``counter("store.cache", cache="padded", outcome="hit")`` returns the
    same :class:`Counter` on every call with identical labels; label values
    are stringified so any scalar is a valid label.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, LabelItems], object] = {}

    def _get(self, kind: str, name: str, labels: dict, factory):
        key = (kind, name,
               tuple(sorted((k, str(v)) for k, v in labels.items())))
        got = self._metrics.get(key)
        if got is None:
            with self._lock:
                got = self._metrics.setdefault(key, factory())
        return got

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels, Histogram)

    def snapshot(self) -> List[dict]:
        """Exporter-facing view: one record per instrument, sorted by name."""
        out = []
        for (kind, name, labels), inst in sorted(self._metrics.items()):
            rec = {"type": kind, "name": name, "labels": dict(labels)}
            if kind == "histogram":
                rec.update(inst.summary())
            else:
                rec["value"] = inst.value
            out.append(rec)
        return out
