"""The port's tracer (trinity_tpu_torch/utils/timings.py) on the host that
drives the card: what a span costs, and where the device's idle time goes.

    python3 tools/measure_tracing.py cost [--workload abstracts1m.mix.batch]
        [--seed N] [--seconds 30] [--windows 6] [--tiny]
    python3 tools/measure_tracing.py idle [--workload ...] [--seed N]
        [--seconds 30] [--tiny]

``cost``:
1. A span alone: 200,000 empty ``trace()`` spans in a loop, recording off
   and then on, less the same loop around ``contextlib.nullcontext()``;
   microseconds a span.
2. The cell's loop (benchmark/harness.py's set-up: the seed's sources, the
   port's index, warm-up, strict seal) for `windows` windows of `seconds`
   in one process, recording off and on in turn (off, on, on, off, ...),
   without the profiler: queries a second of each window, and in the
   recording windows the intervals kept a batch.

``idle``: one traced run of the cell through harness.run_cell (its set-up,
untraced window, traced window and check), with the port's spans recorded
over the traced window; the traced window's idle time split among the
innermost spans that hold it (benchmark/idle.py): the shares of the
program's spans, of the loop's own spans outside them, of no span
(``client``) and of ``exec.device`` (the host waiting on the card), and
the longest idle intervals by the span that holds most of each.

Prints one JSON line on standard output, progress on standard error.
Both measure on a CUDA device. ``--tiny`` cuts the cell to
benchmark/tests/tiny.py's size; ``cost --tiny`` also runs on a CPU, as a
check (``idle`` needs the card's profiler; benchmark/tests/
test_bench_spans.py runs it on the CPU with a stand-in).
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def span_cost(n: int = 200_000) -> dict:
    """Microseconds a span, recording off and on, net of the loop."""
    from trinity_tpu_torch.utils.timings import Tracer

    tr = Tracer()

    def timed(make):
        t = time.perf_counter_ns()
        for _ in range(n):
            with make():
                pass
        return (time.perf_counter_ns() - t) / n / 1e3

    empty = min(timed(contextlib.nullcontext) for _ in range(3))
    off = min(timed(lambda: tr.trace("x")) for _ in range(3))
    tr.record(True)
    on = []
    for _ in range(3):
        on.append(timed(lambda: tr.trace("x")))
        tr.intervals()
    tr.record(False)
    return {"loop_us": empty, "off_us": off - empty,
            "on_us": min(on) - empty, "spans": n}


def cost(cell, seed: int, seconds: float, windows: int,
         device: str) -> dict:
    """The span's cost, and `windows` windows of the cell's loop in one
    process with recording off and on in turn."""
    import torch

    from benchmark import corpus, harness, querygen
    from trinity_tpu_torch.utils import seal, timings

    result = {"span": span_cost()}
    log(f"[span] {result['span']}")
    cfg, traffic = cell.cfg, cell.traffic
    loop = harness.load_file("loops", traffic["loop"])
    dev = torch.device(device)
    sources = corpus.draw_sources(cfg, seed, dev)
    df = querygen.doc_freq(sources[0], cfg["vocab"], dev)
    pool = querygen.make_pool(traffic, sources[0], df, seed)
    batches = querygen.batches(traffic, pool)
    harness.build_native()
    system, _ = corpus.build_system(sources, corpus.term_names(cfg["vocab"]),
                                    device)
    loop.warm(system, batches, traffic)
    seal.seal_programs(strict=True)
    tracer = timings.get_tracer()
    result["windows"] = []
    for w in range(windows):
        on = w % 4 in (1, 2)
        tracer.reset()
        tracer.record(on)
        out = loop.run(system, batches, traffic, seconds)
        tracer.record(False)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        kept = len(tracer.intervals())
        n = max(1, len(out["spans"].get("batch", ()))
                or len(out["spans"].get("search", ())))
        result["windows"].append({
            "recording": on, "qps": out["completed"] / out["window_s"],
            "failed": out["failed"], "calls": n,
            "intervals_a_call": kept / n,
            "spans_a_call": sum(v["count"] for k, v in
                                tracer.snapshot().items()
                                if k != "plan.df_lookups") / n})
        log(f"[window] {result['windows'][-1]}")
    seal.unseal_programs()
    return result


def idle(cell, seed: int, seconds: float, device: str) -> dict:
    """harness.run_cell traced, with profiling.traced wrapped to record the
    port's spans over the traced window and profiling.reduce wrapped to
    split that window's idle time among them; the run's result line beside
    the split."""
    from benchmark import harness, profiling
    from benchmark import idle as split_idle
    from trinity_tpu_torch.utils import timings

    tracer = timings.get_tracer()
    traced, reduce = profiling.traced, profiling.reduce
    got = {}

    @contextlib.contextmanager
    def recording(dev):
        with traced(dev) as tr:
            tracer.intervals()
            tracer.record(True)
            try:
                yield tr
            finally:
                tracer.record(False)

    def reducing(tr, host_spans):
        program = tracer.intervals()
        got.update(split_idle.split(tr, host_spans, program),
                   loop_spans=sorted(host_spans), dropped=tracer.dropped,
                   intervals=sum(r is not None for r in program),
                   window_s=(tr["window"][1] - tr["window"][0]) / 1e9)
        return reduce(tr, host_spans)

    profiling.traced, profiling.reduce = recording, reducing
    try:
        result = harness.run_cell(cell, seed, seconds, True, device,
                                  time.perf_counter(), log)
    finally:
        profiling.traced, profiling.reduce = traced, reduce
    by, total = got["idle_by"], got["idle_s"]
    loop = sum(by.get(n, 0.0) for n in got["loop_spans"])
    share = (lambda s: 100.0 * s / total) if total else (lambda s: 0.0)
    return {
        "correct": result["correct"], "metrics": result["metrics"],
        "device": result["device"],
        "idle": {
            "window_s": got["window_s"], "idle_s": total,
            "program_pct": share(total - loop - by.get("client", 0.0)),
            "loop_pct": share(loop),
            "client_pct": share(by.get("client", 0.0)),
            "device_wait_pct": share(by.get("exec.device", 0.0)),
            "by_span_s": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "gaps": got["idle_gaps"], "intervals": got["intervals"],
            "dropped": got["dropped"]}}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("what", choices=["cost", "idle"])
    p.add_argument("--workload", default="abstracts1m.mix.batch")
    p.add_argument("--seed", type=int, default=2**31 + 1201)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--windows", type=int, default=6)
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args()

    import torch

    from benchmark import harness

    if torch.cuda.is_available():
        device = "cuda:0"
    elif args.tiny and args.what == "cost":
        device = "cpu"
    else:
        raise SystemExit("torch.cuda.is_available() is False: a cell is "
                         "measured on a card; `cost --tiny` checks on the CPU")
    if args.tiny:
        from benchmark.tests.tiny import tiny_cell

        cell = tiny_cell(args.workload, docs=2048, vocab=2048)
    else:
        cell = harness.load_cell(args.workload)
    if args.what == "cost":
        result = cost(cell, args.seed, args.seconds, args.windows, device)
    else:
        result = idle(cell, args.seed, args.seconds, device)
    result.update(workload=args.workload, seed=args.seed, device_name=(
        torch.cuda.get_device_name(0) if device != "cpu" else "cpu"))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
