"""One run of one cell: set-up, the measured window, the trace, the check, the result.

Everything that belongs to a cell is found by name: the cell in
BENCHMARK.json (its configuration and traffic), the configuration's file,
``traffic/<traffic>.json``, the traffic's loop in ``loops/<loop>.py`` and
each metric's reader in ``metrics/<metric>.py``. Adding a cell takes new
files of these kinds and a ``workloads`` entry; no file here changes.

Set-up: the sources are drawn on the device from the seed
(benchmark/corpus.py), the pool of queries from the base source
(benchmark/querygen.py), the port builds its index and the system (an
Executor, or an IndexSourcesCollection for more than one source), the
loop warms every shape of the window, and the port's seal is set strict,
so a launch shape new to the window fails the run. ``setup_s`` runs from
process start to the window's first query. The device's peak memory is
counted from the start of the system's build to the end of the last window.

A traced run (``--trace 1``) measures a second window of the same length
under ``torch.profiler``, right after the first. The profiler slows the
host, so the per-layer metrics of the host (the benchmark's spans, the
port's spans and counters) are read from the first window, and those of
the device (kernel time, busy time, the breakdown) from the second.

After the window the system is freed and the reference judges the answers
(benchmark/compare.py); none of that is in ``setup_s``.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, ".cache")
JAX_NAMES = ("jax", "jaxlib", "flax", "trinity_tpu")


def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in JAX_NAMES})


def load_file(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str) -> SimpleNamespace:
    """The cell's manifest entry, configuration, traffic and metrics."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: {sorted(cells)}")
    w = cells[workload]
    entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    traffic = load_traffic(w["traffic"])

    def mine(m):
        return workload in m.get("workloads", [workload])

    return SimpleNamespace(
        name=workload, chips=w["chips"], cfg=cfg, traffic=traffic,
        end_to_end=[m for m in manifest["end_to_end"] if mine(m)],
        per_layer=[m for m in manifest["per_layer"] if mine(m)])


def load_traffic(name: str) -> dict:
    """``traffic/<name>.json``; a file that names a ``base`` traffic takes
    every key of that one, its own keys over them."""
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        traffic = json.load(f)
    if "base" in traffic:
        traffic = {**load_traffic(traffic.pop("base")), **traffic}
    return traffic


def build_native() -> None:
    """Compile the port's host library (native/trinity_host.cpp) for this
    machine's CPU into a fixed directory of the checkout, once per source,
    and point the port at it."""
    src = os.path.join(ROOT, "native", "trinity_host.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(CACHE, "native")
    lib = os.path.join(out_dir, f"libtrinity_host-{digest}.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o",
                        lib + ".tmp", src], check=True)
        os.replace(lib + ".tmp", lib)
    os.environ["TRINITY_HOST_LIB"] = lib


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             started: float, log=print) -> dict:
    """Run `cell` once; returns the result line as a dict, its "checks"
    (each number compared, with its limit) last. `started`: the process's
    start on time.perf_counter."""
    from benchmark import bytecount, compare, corpus, profiling, querygen
    from benchmark.reference import Reference

    cfg, traffic = cell.cfg, cell.traffic
    loop = load_file("loops", traffic["loop"])
    dev = torch.device(device)
    t = time.perf_counter()
    sources = corpus.draw_sources(cfg, seed, dev)
    df = querygen.doc_freq(sources[0], cfg["vocab"], dev)
    pool = querygen.make_pool(traffic, sources[0], df, seed)
    batches = querygen.batches(traffic, pool)
    log(f"[setup] drew {sum(len(s.ids) for s in sources)} documents, "
        f"{sum(len(s.tokens) for s in sources)} tokens and {len(pool)} "
        f"queries in {time.perf_counter() - t:.3f} s")

    build_native()
    from trinity_tpu_torch.utils import kernels, seal, timings

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    names = corpus.term_names(cfg["vocab"])
    system, segs = corpus.build_system(sources, names, device)
    log(f"[setup] the port indexed {len(segs)} source(s) in "
        f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    loop.warm(system, batches, traffic)
    seal.seal_programs(strict=True)
    log(f"[setup] warmed in {time.perf_counter() - t:.3f} s")

    timings.get_tracer().reset()
    kernels.reset_launches()
    pauses = []
    gc.callbacks.append(gc_timer(pauses))
    cpu0 = os.times()
    setup_s = time.perf_counter() - started
    out = loop.run(system, batches, traffic, seconds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gc.callbacks.pop()
    log_window(log, out, pauses, cpu0, os.times())
    program_spans = timings.get_tracer().snapshot()
    launches = dict(kernels.launches)
    traced = None
    if trace:
        # the profiler slows the host, so the host's spans and counters
        # come from the window above and only the device's from this one
        with profiling.traced(dev) as tr:
            traced = loop.run(system, batches, traffic, seconds)
        log(f"[trace] {traced['completed'] / traced['window_s']:.2f} "
            f"queries/s under the profiler against "
            f"{out['completed'] / out['window_s']:.2f} without it")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    seal.unseal_programs()
    found = jax_modules()
    if found:
        raise JaxLoaded(found)

    run = SimpleNamespace(
        loop=traffic["loop"], window_s=out["window_s"],
        completed=out["completed"],
        batches=len(out["spans"].get("batch", ())),
        searches=len(out["spans"].get("search", ())),
        spans={n: [b - a for a, b in ss] for n, ss in out["spans"].items()},
        setup_s=setup_s, peak_bytes=peak, program_spans=program_spans,
        launches=launches, profile=None, least_bytes=None)
    if trace:
        run.profile = profiling.reduce(
            tr, {n: ss for n, ss in traced["spans"].items() if n != "batch"})
        run.profile["calls"] = max(len(traced["spans"].get("batch", ())),
                                   len(traced["spans"].get("search", ())))
        live = [s for s in segs if s.n_docs]
        per_batch = [bytecount.batch_bytes(live, [q for _, q in b],
                                           traffic["k"]) for b in batches]
        run.least_bytes = sum(per_batch[bi] for bi in traced["launched"])
        for qi, seen in traced["answers"].items():
            out["answers"][qi] |= seen
        out["attempted"] += traced["attempted"]
        out["failed"] += traced["failed"]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_file("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    answers = out["answers"]
    attempted, failed = out["attempted"], out["failed"]
    del system, segs, out, traced
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        log(f"[check] device bytes still allocated once the system is freed: "
            f"{torch.cuda.memory_allocated(dev)}")
    t = time.perf_counter()
    ref = Reference(sources, cfg["vocab"], dev)
    nums = compare.judge(ref, pool, answers, traffic["k"], failed)
    log(f"[check] judged {nums['answers']} distinct answers of "
        f"{len(answers)} queries in {time.perf_counter() - t:.3f} s")
    result = {
        "correct": compare.correct(nums),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_info(dev, peak, run.profile),
    }
    if run.profile is not None:
        result["breakdown"] = {k: run.profile[k]
                               for k in ("device_ops", "idle_gaps")}
    result["checks"] = compare.checks(nums)
    return result


def log_window(log, out: dict, pauses: list, cpu0, cpu1) -> None:
    """The window's host side on standard error: CPU time, time a call,
    the port's planning time and kernel launches, garbage collections."""
    from trinity_tpu_torch.utils import kernels, timings

    with open("/proc/loadavg") as f:
        load = f.read().split()[:3]
    log(f"[window] host CPU {cpu1.user - cpu0.user:.3f} s user, "
        f"{cpu1.system - cpu0.system:.3f} s system over "
        f"{out['window_s']:.3f} s; load average {' '.join(load)}; "
        f"{len(os.sched_getaffinity(0))} cores")
    calls = {n: (len(ss), sum(b - a for a, b in ss))
             for n, ss in out["spans"].items()}
    prep = timings.get_tracer().snapshot().get("exec.prepare", {})
    log("[window] host ms a call: " + ", ".join(
        f"{n} {t / max(c, 1) * 1e3:.3f} ({c} calls)"
        for n, (c, t) in calls.items())
        + f"; exec.prepare {prep.get('total_ms', 0.0):.1f} ms in all; "
        f"launches {dict(kernels.launches)}")
    longest = max(pauses, key=lambda g: g[1], default=("-", 0.0))
    log(f"[window] {out['completed']} queries answered in "
        f"{out['window_s']:.3f} s; garbage collections: {len(pauses)}, "
        f"{sum(p for _, p in pauses):.4f} s in all, the longest "
        f"{longest[1]:.4f} s (generation {longest[0]}); objects the "
        f"collector tracks: {len(gc.get_objects())}")


def gc_timer(pauses: list):
    """A gc callback that appends (generation, seconds) of each collection."""
    start = {}

    def cb(phase, info):
        if phase == "start":
            start["t"] = time.perf_counter()
        elif "t" in start:
            pauses.append((info["generation"],
                           time.perf_counter() - start.pop("t")))
    return cb


class JaxLoaded(RuntimeError):
    pass


def device_info(dev, peak: int, profile) -> dict:
    info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": peak}
    if profile is not None:
        info.update(busy_s=profile["busy_s"], window_s=profile["window_s"])
    return info
