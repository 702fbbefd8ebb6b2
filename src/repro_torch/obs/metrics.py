"""Counter / gauge / streaming-histogram registry.

The port's copy of ``repro.obs.metrics``, unchanged.

Everything here is O(1) per observation and retains **no samples**:
histograms stream into fixed log-scale buckets (geometric edges, a
configurable number per decade), so a million-consult run costs the same
memory as a ten-consult run.  Quantiles are read back from the bucket
counts — accurate to one bucket width (a factor of ``10**(1/bpd)``),
which the registry tests pin against exact numpy percentiles.

The registry itself is a flat name -> instrument map.  Instrument names
are free-form dotted strings (``decision_latency_s``,
``free_gpus.3.v100``); :meth:`MetricsRegistry.summary` renders the whole
registry as one plain-JSON dict for files, CLIs and baselines.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional


class Counter:
    """Monotone event counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming histogram over fixed log-scale buckets.

    Bucket ``i`` covers ``[lo * F**i, lo * F**(i+1))`` with
    ``F = 10 ** (1 / buckets_per_decade)``; values below ``lo`` land in a
    dedicated underflow bucket, values at or above ``hi`` in an overflow
    bucket.  Exact ``count`` / ``sum`` / ``min`` / ``max`` are kept on
    the side, so means and extrema have no bucket error — only interior
    quantiles are quantized (to one bucket, i.e. a factor of ``F``).
    Non-positive values are counted in the underflow bucket (log-scale
    buckets cannot place them).
    """

    __slots__ = ("name", "lo", "hi", "bpd", "_log_lo", "_inv_log_f",
                 "n_buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, lo: float = 1e-7, hi: float = 1e5,
                 buckets_per_decade: int = 8):
        if not (lo > 0.0 and hi > lo):
            raise ValueError("need 0 < lo < hi")
        self.name = name
        self.lo = float(lo)
        self.hi = float(hi)
        self.bpd = int(buckets_per_decade)
        self._log_lo = math.log10(self.lo)
        self._inv_log_f = float(self.bpd)      # 1 / log10(F)
        self.n_buckets = int(math.ceil(
            (math.log10(self.hi) - self._log_lo) * self.bpd))
        # [underflow] + interior + [overflow]
        self.counts = [0] * (self.n_buckets + 2)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _bucket(self, v: float) -> int:
        if v < self.lo:                       # includes v <= 0
            return 0
        if v >= self.hi:
            return self.n_buckets + 1
        i = int((math.log10(v) - self._log_lo) * self._inv_log_f)
        # float guard: log10 rounding can land one bucket out at an edge
        return min(max(i, 0), self.n_buckets - 1) + 1

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[self._bucket(v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def _edges(self, i: int):
        """(lo, hi) value edges of interior bucket ``i`` (1-based)."""
        e0 = 10.0 ** (self._log_lo + (i - 1) / self.bpd)
        e1 = 10.0 ** (self._log_lo + i / self.bpd)
        return e0, e1

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile from the bucket counts.

        Interior buckets report their geometric midpoint clamped to the
        observed [min, max]; the underflow/overflow buckets report the
        exact observed min/max (those extremes are tracked exactly)."""
        if self.count == 0:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        rank = max(1, int(math.ceil(q * self.count)))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                if i == 0:
                    return self.min
                if i == self.n_buckets + 1:
                    return self.max
                e0, e1 = self._edges(i)
                mid = math.sqrt(e0 * e1)
                return min(max(mid, self.min), self.max)
        return self.max

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_json(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": self.mean(),
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Flat get-or-create registry of counters, gauges and histograms."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, **kwargs) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, **kwargs)
        return h

    def names(self) -> List[str]:
        return sorted(set(self._counters) | set(self._gauges)
                      | set(self._histograms))

    def summary(self) -> dict:
        """Whole registry as one plain-JSON dict (sorted keys)."""
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.to_json()
                           for k, h in sorted(self._histograms.items())},
        }
