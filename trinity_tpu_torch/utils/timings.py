# Copy of trinity_tpu/utils/timings.py; only its imports name the port.
"""Per-phase execution tracing.

The reference times compile / decoder-init / execute phases with
Timings::Microseconds ticks behind a compile-time `traceMetrics` flag
(exec.cpp:134-237, SURVEY §5.1). Here tracing is runtime-switchable: wrap
phases with `trace(name)` and read counters from `get_tracer()`; enable
detailed stderr logging with TRINITY_TPU_TRACE=1.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class Tracer:
    enabled_log: bool = False
    totals_us: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def trace(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e6
            self.totals_us[name] += dt
            self.counts[name] += 1
            if self.enabled_log:
                print(f"[trinity-trace] {name}: {dt:.0f}us", file=sys.stderr)

    def add(self, name: str, n: int = 1):
        self.counts[name] += n

    def snapshot(self) -> Dict[str, dict]:
        return {
            k: {
                "total_ms": self.totals_us[k] / 1e3,
                "count": self.counts[k],
                "avg_us": self.totals_us[k] / max(1, self.counts[k]),
            }
            for k in set(self.totals_us) | set(self.counts)
        }

    def reset(self):
        self.totals_us.clear()
        self.counts.clear()


_tracer = Tracer(enabled_log=os.environ.get("TRINITY_TPU_TRACE", "") == "1")


def get_tracer() -> Tracer:
    return _tracer


def trace(name: str):
    return _tracer.trace(name)
