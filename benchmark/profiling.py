"""The device trace of a window, reduced to busy time, kernel time and a breakdown.

The window runs under ``torch.profiler`` with CUDA activity only (no CPU
op events, so the host pays little for it). Device events are the kernels,
copies and sets that CUPTI reports. The host's own spans (the benchmark's,
on ``time.perf_counter_ns``) are put on the device's clock by a marker: the
device is idle when the marker op is launched, so its event is the
trace's first, and it starts a launch latency (some microseconds) after
the host's reading.

Busy time is the union of device event intervals inside the window, as
chip_smoke.py's ``--profile`` takes it (there: device time over wall
time); kernel time is the sum of kernel durations.
"""

from __future__ import annotations

import contextlib
import time

import torch

TOP = 10


@contextlib.contextmanager
def traced(device):
    """Profile the body; yields a dict filled on exit with the device
    events [(name, start_ns, end_ns)] on the host's perf_counter_ns clock
    and the window's (start_ns, end_ns)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        mark = time.perf_counter_ns()
        torch.ones(1, device=device)
        yield out
        torch.cuda.synchronize(device)
        end = time.perf_counter_ns()
    evs = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA)
    if not evs:
        raise RuntimeError("the profiler recorded no device event")
    shift = mark - evs[0][0]
    out["events"] = [(n, a + shift, b + shift) for a, b, n in evs[1:]]
    out["window"] = (mark, end)


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def reduce(trace: dict, host_spans: dict) -> dict:
    """{busy_s, window_s, kernel_s, device_ops, idle_gaps} of a traced
    window. host_spans: {name: [(start_s, end_s)]} on perf_counter."""
    t0, t1 = trace["window"]
    evs = [(n, max(a, t0), min(b, t1)) for n, a, b in trace["events"]
           if b > t0 and a < t1]
    by_name: dict = {}
    kernel_ns = 0
    for n, a, b in evs:
        by_name[n] = by_name.get(n, 0) + (b - a)
        if is_kernel(n):
            kernel_ns += b - a
    busy_ns, gaps, cur = 0, [], t0
    for _, a, b in sorted(evs, key=lambda e: e[1]):
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy_ns += b - max(a, cur)
            cur = b
    if t1 > cur:
        gaps.append((cur, t1))
    spans = sorted((int(a * 1e9), int(b * 1e9), name)
                   for name, ss in host_spans.items() for a, b in ss)

    def doing(t):
        """The innermost host span holding host time t (ns)."""
        best = None
        for a, b, name in spans:
            if a > t:
                break
            if b >= t and (best is None or a >= best[0]):
                best = (a, name)
        return best[1] if best else "client"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "kernel_s": kernel_ns / 1e9,
        "device_ops": [[n[:120], ns / 1e9] for n, ns in top_ops],
        "idle_gaps": [[doing(a), (b - a) / 1e9] for a, b in longest],
    }
