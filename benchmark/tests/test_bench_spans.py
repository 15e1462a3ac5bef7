"""The benchmark's reading of the port's spans.

- ``idle.split`` splits each idle interval of the device among the
  innermost host spans covering it (the program's inside the loop's),
  sends what no span covers to ``client``, finds the idle intervals
  ``profiling.reduce`` finds, and names the longest by the span that holds
  most of each; spans still open when the list was read are skipped.
- Each reader of a program span or counter returns its value on a made-up
  run, and None where its span is missing.
- A tiny cell's traced run on the CPU, with a stand-in for the profiler,
  reports every per-layer metric its cell lists, the new ones included;
  tools/measure_tracing.py's ``idle`` puts that run's idle time down to
  the port's spans, and refuses a full cell without a card.
"""

import contextlib
import importlib.util
import os
import sys
import time
from types import SimpleNamespace

import pytest

from benchmark import harness, idle, profiling
from benchmark.tests.tiny import tiny_cell
US = 1000  # ns

# a loop span around a launch; inside it the program's spans, nested
LOOP = {"launch_batch": [(10e-6, 60e-6)]}
PROGRAM = [
    ("exec.launch", 12 * US, 58 * US, -1, 1, {"source": 0}),
    ("exec.prepare", 13 * US, 30 * US, 0, 1, {}),
    ("exec.phrase", 35 * US, 50 * US, 0, 1, {}),
    ("host.gc", 40 * US, 45 * US, 2, 1, {"generation": 2}),
]
TRACE = {"window": (0, 100 * US),
         "events": [("k1", 0, 20 * US), ("Memcpy DtoH", 50 * US, 55 * US),
                    ("k2", 70 * US, 80 * US)]}


def test_split_idle_among_innermost_spans():
    got = idle.split(TRACE, LOOP, PROGRAM)
    want = {"exec.prepare": 10, "exec.launch": 5 + 3, "exec.phrase": 10,
            "host.gc": 5, "launch_batch": 2, "client": 10 + 20}
    assert set(got["idle_by"]) == set(want)
    for name, us in want.items():
        assert got["idle_by"][name] == pytest.approx(us * 1e-6), name
    assert got["idle_s"] == pytest.approx(sum(want.values()) * 1e-6)
    # each gap named by the span holding most of it (a tie: the first)
    assert [n for n, _ in got["idle_gaps"]] == ["exec.prepare", "client",
                                                "client"]


def test_split_finds_the_gaps_reduce_finds():
    old = profiling.reduce(TRACE, LOOP)
    got = idle.split(TRACE, LOOP, PROGRAM)
    assert got["idle_s"] == pytest.approx(old["window_s"] - old["busy_s"])
    assert [d for _, d in got["idle_gaps"]] == [d for _, d in
                                                old["idle_gaps"]]
    assert idle.split(TRACE, LOOP, None)["idle_by"] == pytest.approx(
        {"launch_batch": 35e-6, "client": 30e-6})


def test_a_pause_is_named_by_what_holds_it():
    """A collection that starts just after the copy back: the gap starts
    inside exec.device but reads host.gc."""
    trace = {"window": (0, 100 * US), "events": [("Memcpy DtoH", 0, 4 * US)]}
    program = [("exec.device", 1 * US, 6 * US, -1, 1, {}),
               ("host.gc", 6 * US, 96 * US, -1, 1, {"generation": 2})]
    got = idle.split(trace, {}, program)
    assert got["idle_gaps"] == [["host.gc", pytest.approx(96e-6)]]
    assert got["idle_by"] == pytest.approx(
        {"exec.device": 2e-6, "host.gc": 90e-6, "client": 4e-6})


def test_open_spans_are_skipped():
    """A span still open when the list was read leaves None in its slot."""
    got = idle.split(TRACE, LOOP, [None] + PROGRAM[1:])
    assert "exec.launch" not in got["idle_by"]
    assert got["idle_by"]["launch_batch"] == pytest.approx(10e-6)


def test_innermost_orders_ties_by_nesting():
    spans = sorted([(0, 10, "outer"), (0, 5, "inner"), (5, 10, "next")])
    assert idle.innermost(spans) == [(0, 5, "inner"), (5, 10, "next")]
    # two threads' spans overlapping without nesting
    spans = [(0, 10, "a"), (5, 15, "b")]
    assert idle.innermost(spans) == [(0, 5, "a"), (5, 10, "b"),
                                     (10, 15, "b")]


def _run(**kw):
    spans = {
        "exec.phrase": {"total_ms": 8.0, "count": 20, "avg_us": 400.0},
        "exec.device": {"total_ms": 2.0, "count": 4, "avg_us": 500.0},
        "host.gc": {"total_ms": 1.2, "count": 9, "avg_us": 133.3},
        "collection.merge": {"total_ms": 0.4, "count": 4, "avg_us": 100.0},
        "plan.df_lookups": {"total_ms": 0.0, "count": 900, "avg_us": 0.0},
        "exec.group.flat": {"total_ms": 3.0, "count": 6, "avg_us": 500.0},
        "exec.group.posph": {"total_ms": 1.0, "count": 2, "avg_us": 500.0},
    }
    run = SimpleNamespace(batches=4, searches=2, program_spans=spans)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


READS = {
    "phrase_ms.batch": (2.0, "exec.phrase"),
    "finish_wait_ms.batch": (0.5, "exec.device"),
    "gc_ms.batch": (0.3, "host.gc"),
    "merge_ms.batch": (0.1, "collection.merge"),
    "df_lookups.batch": (225.0, "plan.df_lookups"),
    "group_ms.search": (2.0, "exec.group."),
}


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_value_and_missing_span(name):
    value, span = READS[name]
    read = harness.load_file("metrics", name).read
    assert read(_run()) == pytest.approx(value)
    run = _run()
    run.program_spans = {k: v for k, v in run.program_spans.items()
                         if not k.startswith(span)}
    assert read(run) is None


@contextlib.contextmanager
def stand_in_profiler(device):
    """profiling.traced's result without a card: one device event over the
    middle third of the window."""
    out = {}
    mark = time.perf_counter_ns()
    yield out
    end = time.perf_counter_ns()
    third = (end - mark) // 3
    out["events"] = [("kernel", mark + third, mark + 2 * third)]
    out["window"] = (mark, end)


@pytest.mark.parametrize("name", ["abstracts1m.mix.batch",
                                  "abstracts1m.mix.search",
                                  "abstracts1m-3gen.mix.batch"])
def test_tiny_traced_run_reports_every_metric(name, monkeypatch):
    monkeypatch.setattr(profiling, "traced", stand_in_profiler)
    cell = tiny_cell(name, docs=2048, vocab=2048)
    lines = []
    res = harness.run_cell(cell, 2**31 + 11, 0.5, True, "cpu",
                           time.perf_counter(), lines.append)
    assert res["correct"], res["checks"]
    assert {m["name"] for m in cell.per_layer} == set(res["metrics"])
    for m, v in res["metrics"].items():
        if m.endswith(("_ms.batch", "_ms.search")):
            assert v["value"] > 0, (m, v)


def _tool():
    path = os.path.join(harness.ROOT, "tools", "measure_tracing.py")
    spec = importlib.util.spec_from_file_location("measure_tracing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["abstracts1m.mix.batch",
                                  "abstracts1m-3gen.mix.batch"])
def test_tool_puts_idle_time_down_to_program_spans(name, monkeypatch):
    monkeypatch.setattr(profiling, "traced", stand_in_profiler)
    tool = _tool()
    cell = tiny_cell(name, docs=2048, vocab=2048)
    got = tool.idle(cell, 2**31 + 13, 0.5, "cpu")
    assert got["correct"]
    assert profiling.traced is stand_in_profiler  # the wrappers are undone
    i = got["idle"]
    assert i["intervals"] > 0 and i["dropped"] == 0
    assert sum(i["by_span_s"].values()) == pytest.approx(i["idle_s"])
    assert i["program_pct"] + i["loop_pct"] + i["client_pct"] == (
        pytest.approx(100.0))
    assert i["program_pct"] > 50.0
    assert {"exec.launch", "exec.prepare"} <= set(i["by_span_s"])


def test_tool_wants_a_card_for_a_full_cell(monkeypatch):
    import torch

    tool = _tool()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["idle"], ["cost"], ["idle", "--tiny"]):
        monkeypatch.setattr(sys, "argv", ["measure_tracing.py"] + argv)
        with pytest.raises(SystemExit, match="--tiny"):
            tool.main()
