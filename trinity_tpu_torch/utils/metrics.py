# Copy of trinity_tpu/utils/metrics.py; only its imports name the port.
"""Serving metrics: counters + log-bucketed latency histograms (§5.5).

The reference's observability is the Timings phase tracer (exec.cpp:134-237)
— per-phase totals only. A serving deployment additionally needs request
counters and latency QUANTILES (the p99 story), so this module adds a
process-wide registry of named counters and histograms with ~4%-resolution
logarithmic buckets (fixed memory, O(1) observe, mergeable across
processes by summing bucket arrays).

Usage:
    from trinity_tpu_torch.utils.metrics import get_metrics
    m = get_metrics()
    m.count("search.queries")
    m.observe_us("search.latency", dt_us)
    m.snapshot()["search.latency"]["p99_us"]
"""

from __future__ import annotations

import math
import threading
from typing import Dict

import numpy as np

# bucket boundaries: value v -> bucket floor(log(v)/log(GROWTH)); GROWTH
# 1.04 gives ~4% relative resolution over [1us, ~1000s] in ~600 buckets
_GROWTH = 1.04
_LOG_G = math.log(_GROWTH)
_NBUCKETS = 640


class Histogram:
    """Fixed-size logarithmic histogram of positive values (microseconds)."""

    __slots__ = ("buckets", "n", "total", "vmin", "vmax")

    def __init__(self):
        self.buckets = np.zeros(_NBUCKETS, np.int64)
        self.n = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = 0.0

    def observe(self, v: float):
        if v <= 0:
            v = 1e-9
        b = min(_NBUCKETS - 1, max(0, int(math.log(v) / _LOG_G)))
        self.buckets[b] += 1
        self.n += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile observation."""
        if self.n == 0:
            return 0.0
        target = q * self.n
        c = np.cumsum(self.buckets)
        b = int(np.searchsorted(c, target, side="left"))
        return _GROWTH ** (b + 1)

    def summary(self) -> dict:
        return {
            "count": self.n,
            "mean_us": self.total / max(1, self.n),
            "min_us": 0.0 if self.n == 0 else self.vmin,
            "max_us": self.vmax,
            "p50_us": self.quantile(0.50),
            "p95_us": self.quantile(0.95),
            "p99_us": self.quantile(0.99),
        }


class Metrics:
    """Thread-safe registry of counters and histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._hists: Dict[str, Histogram] = {}

    def count(self, name: str, n: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def observe_us(self, name: str, v_us: float):
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(v_us)

    def snapshot(self) -> Dict[str, dict]:
        """Counters as {"value": n}, histograms as quantile summaries, plus
        the phase tracer's totals (utils/timings.py) under their names."""
        from trinity_tpu_torch.utils.timings import get_tracer

        with self._lock:
            out: Dict[str, dict] = {
                k: {"value": v} for k, v in self._counters.items()
            }
            for k, h in self._hists.items():
                out[k] = h.summary()
        for k, v in get_tracer().snapshot().items():
            out.setdefault(f"trace.{k}", v)
        return out

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._hists.clear()


_metrics = Metrics()


def get_metrics() -> Metrics:
    return _metrics
