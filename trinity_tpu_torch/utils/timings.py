"""Per-phase execution tracing: totals always, intervals on request.

The reference times compile / decoder-init / execute phases with
Timings::Microseconds ticks behind a compile-time `traceMetrics` flag
(exec.cpp:134-237, SURVEY §5.1). Here tracing is runtime-switchable: wrap
phases with `trace(name)` and read the per-name totals from
`get_tracer().snapshot()` ({name: {"total_ms", "count", "avg_us"}}); `add`
counts without timing.

``get_tracer().record(True)`` also keeps every span as an interval,
``(name, start_ns, end_ns, parent, batch, attrs)``, until ``intervals()``
hands the list over and clears it. Times are ``time.perf_counter_ns``, the
host clock a device trace is shifted onto (benchmark/profiling.py), so a
span and a device event compare directly. ``parent`` is the list index of
the enclosing span on the same thread (-1 at the top); ``batch`` is the
id a launch span was given (``new_batch``) and its children inherit. At
most ``cap`` intervals are kept; the rest count in ``dropped``. While
recording is off a span costs one clock pair, one lock and two dict
updates.

Garbage collections are spans too: ``host.gc`` (attrs: generation), from
a ``gc.callbacks`` entry the process's tracer (``get_tracer()``) installs
at its first span. Other ``Tracer`` instances time no collections.
"""

from __future__ import annotations

import gc
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

CAP = 2_000_000
_clock = time.perf_counter_ns


class _Span:
    """One open span. On a recording tracer it takes its slot of the list
    when it opens, so the spans inside it can name it as their parent."""

    __slots__ = ("tr", "name", "batch", "attrs", "t0", "stack", "slot",
                 "parent", "epoch")

    def __init__(self, tr: "Tracer", name: str, batch, attrs: dict):
        self.tr, self.name, self.batch, self.attrs = tr, name, batch, attrs
        self.stack = self.slot = None

    def __enter__(self):
        tr = self.tr
        if not tr._gc_hooked:
            tr._hook_gc()
        if tr._recording:
            stack = self.stack = tr._stack()
            top = stack[-1] if stack else None
            if self.batch is None and top is not None:
                self.batch = top.batch
            with tr._lock:
                self.epoch = tr._epoch
                self.parent = (top.slot if top is not None
                               and top.slot is not None
                               and top.epoch == tr._epoch else -1)
                if len(tr._records) < tr.cap:
                    self.slot = len(tr._records)
                    tr._records.append(None)
                else:
                    tr.dropped += 1
            stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        tr = self.tr
        if self.stack is not None:
            if self.stack and self.stack[-1] is self:
                self.stack.pop()
            elif self in self.stack:  # closed out of order
                self.stack.remove(self)
        with tr._lock:
            tr._totals_ns[self.name] += t1 - self.t0
            tr._counts[self.name] += 1
            if self.slot is not None:
                if self.epoch == tr._epoch:
                    tr._records[self.slot] = (self.name, self.t0, t1,
                                              self.parent, self.batch,
                                              self.attrs)
                else:  # the list was handed over while the span was open
                    tr.dropped += 1
        return False


class Tracer:
    """Per-name span totals and counters under a lock, and, while
    recording, the spans' intervals (module docstring)."""

    def __init__(self, cap: int = CAP, hook_gc: bool = False):
        self.cap = cap
        self.dropped = 0
        self._lock = threading.RLock()  # a gc callback may run inside it
        self._totals_ns: Dict[str, int] = defaultdict(int)
        self._counts: Dict[str, int] = defaultdict(int)
        self._recording = False
        self._records: list = []
        self._epoch = 0
        self._local = threading.local()
        self._batches = itertools.count(1)
        self._gc_hooked = not hook_gc  # True: nothing left to install

    def trace(self, name: str, batch: Optional[int] = None, **attrs):
        """A context manager timing its body under `name`; `batch` names
        the batch it belongs to (else the enclosing span's)."""
        return _Span(self, name, batch, attrs)

    def add(self, name: str, n: int = 1):
        with self._lock:
            self._counts[name] += n

    def new_batch(self) -> int:
        """A fresh batch id (a launch span's)."""
        return next(self._batches)

    def current_batch(self) -> Optional[int]:
        """The batch of the innermost open span on this thread while
        recording; None otherwise."""
        stack = getattr(self._local, "stack", None)
        return stack[-1].batch if stack else None

    def record(self, on: bool) -> None:
        """Keep (True) or stop keeping (False) each span's interval."""
        if not self._gc_hooked:
            self._hook_gc()
        self._recording = bool(on)

    def intervals(self) -> list:
        """The recorded intervals, oldest first; clears the list. A span
        still open now is left out (its slot holds None) and counts as
        dropped when it closes."""
        with self._lock:
            out, self._records = self._records, []
            self._epoch += 1
        return out

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            totals, counts = dict(self._totals_ns), dict(self._counts)
        return {
            k: {
                "total_ms": totals.get(k, 0) / 1e6,
                "count": counts.get(k, 0),
                "avg_us": totals.get(k, 0) / 1e3 / max(1, counts.get(k, 0)),
            }
            for k in set(totals) | set(counts)
        }

    def reset(self):
        """Clear the totals, the counters, the intervals and the drops."""
        with self._lock:
            self._totals_ns.clear()
            self._counts.clear()
            self.dropped = 0
        self.intervals()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _hook_gc(self) -> None:
        """Time each garbage collection as a ``host.gc`` span."""
        with self._lock:
            if self._gc_hooked:
                return
            self._gc_hooked = True
        local = threading.local()

        def on_gc(phase, info):
            if phase == "start":
                local.span = _Span(self, "host.gc", None,
                                   {"generation": info["generation"]})
                local.span.__enter__()
            else:
                span = getattr(local, "span", None)
                if span is not None:
                    local.span = None
                    span.__exit__(None, None, None)

        gc.callbacks.append(on_gc)


_tracer = Tracer(hook_gc=True)


def get_tracer() -> Tracer:
    return _tracer


trace = _tracer.trace  # the process's tracer, one call less a span
