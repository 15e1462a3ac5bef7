"""A traced window's device-idle time put down to the host spans that hold it.

The port's tracer (trinity_tpu_torch/utils/timings.py) records its spans,
``(name, start_ns, end_ns, parent, batch, attrs)``, on
``time.perf_counter_ns``: the clock profiling.traced shifts the device
events onto, so a span and a device event compare directly. ``split``
cuts the window's idle intervals (as profiling.reduce finds them) among
the innermost host spans covering them, the program's inside the loop's,
and gives ``client`` what no span covers. tools/measure_tracing.py reads
it; profiling.reduce does not call it yet.
"""

from __future__ import annotations

import bisect

from benchmark.profiling import TOP


def gaps(trace: dict) -> list:
    """The idle intervals [(start_ns, end_ns)] of a traced window: its time
    outside the union of device events, as profiling.reduce takes it."""
    t0, t1 = trace["window"]
    out, cur = [], t0
    for a, b in sorted((max(a, t0), min(b, t1)) for _, a, b in
                       trace["events"] if b > t0 and a < t1):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        out.append((cur, t1))
    return out


def innermost(spans: list) -> list:
    """Host time cut into [(start, end, name)] pieces, in order, each named
    by the innermost span open over it (the open span that started last);
    spans: [(start, end, name)]. No piece where no span is open."""
    # at one instant: closes first, the inner one first; then opens, the
    # outer one first
    events = sorted([(a, 1, -b, i) for i, (a, b, _) in enumerate(spans)
                     if b > a]
                    + [(b, 0, -a, i) for i, (a, b, _) in enumerate(spans)
                       if b > a])
    pieces, stack, prev = [], [], None
    for t, opens, _, i in events:
        if stack and t > prev:
            pieces.append((prev, t, spans[stack[-1]][2]))
        prev = t
        if opens:
            stack.append(i)
        elif stack[-1] == i:
            stack.pop()
        else:  # spans of two threads may overlap without nesting
            stack.remove(i)
    return pieces


def idle_by(idle: list, pieces: list) -> dict:
    """{span name: seconds} of the idle intervals `idle` (ns), each split
    among the innermost spans covering it (`pieces`, from innermost());
    ``client`` takes what no span covers."""
    out = {}
    ends = [p[1] for p in pieces]
    for a, b in idle:
        covered = 0
        k = bisect.bisect_right(ends, a)
        while k < len(pieces) and pieces[k][0] < b:
            p0, p1, name = pieces[k]
            ov = min(b, p1) - max(a, p0)
            out[name] = out.get(name, 0) + ov
            covered += ov
            k += 1
        if b - a > covered:
            out["client"] = out.get("client", 0) + (b - a - covered)
    return {n: ns / 1e9 for n, ns in out.items()}


def split(trace: dict, host_spans: dict, program) -> dict:
    """{idle_s, idle_by, idle_gaps} of a traced window: idle_by as above,
    and its TOP longest idle intervals, each named by the span that holds
    most of it. host_spans: the loop's {name: [(start_s, end_s)]} on
    perf_counter; program: the port's recorded intervals (None entries,
    spans still open when they were read, are skipped)."""
    pieces = innermost(sorted(
        [(int(a * 1e9), int(b * 1e9), name)
         for name, ss in host_spans.items() for a, b in ss]
        + [(r[1], r[2], r[0]) for r in program or () if r is not None]))
    idle = gaps(trace)

    def holder(gap):
        by = idle_by([gap], pieces)
        return max(by, key=by.get)

    longest = sorted(idle, key=lambda g: g[0] - g[1])[:TOP]
    return {"idle_s": sum(b - a for a, b in idle) / 1e9,
            "idle_by": idle_by(idle, pieces),
            "idle_gaps": [[holder(g), (g[1] - g[0]) / 1e9] for g in longest]}
