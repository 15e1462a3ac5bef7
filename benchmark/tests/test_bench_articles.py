"""The article cell, ``wikimedium512k.mix40.batch``, on the CPU.

- Its traffic resolves to the bench mix under mix.batch's loop, over 80
  batches of 120.
- Its configuration is the article shape: 140-200 tokens a document.
- Each reader of the lazy route's span and counters returns its value on
  a made-up run, and None where its span or counter is missing.
- A tiny run of the cell, untraced and traced (with a stand-in for the
  profiler), is correct against the reference, runs every phrase on the
  lazy route, and reports every metric the cell lists.
"""

import time
from types import SimpleNamespace

import pytest

from benchmark import harness, profiling
from benchmark.tests.test_bench_spans import stand_in_profiler
from benchmark.tests.tiny import tiny_cell
from trinity_tpu_torch.utils import timings

CELL = "wikimedium512k.mix40.batch"


def test_traffic_resolves_to_the_bench_mix_over_80_batches():
    t = harness.load_traffic("mix40.batch")
    mix = harness.load_traffic("mix.batch")
    assert t.pop("about") != mix.pop("about")
    assert t == dict(mix, pool_batches=80)
    assert t["loop"] == "pipelined" and t["batch"] == 120 and t["k"] == 10
    assert {c["name"] for c in t["classes"]} == {
        "and2", "and_wide", "or3", "or_wide", "not1", "not2", "phrase2",
        "phrase3", "kofn", "or_of_and"}


def test_cell_is_the_article_configuration():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1
    assert cell.cfg["docs"] == 524288 and cell.cfg["vocab"] == 524288
    assert cell.cfg["doc_len"] == [140, 200] and cell.cfg["generations"] == []
    assert {m["name"] for m in cell.end_to_end} == {
        "qps", "batch_p95_ms", "device_peak_gib", "setup_s"}


READS = {
    "lazy_ms.batch": (1.5, "exec.group.lazyph"),
    "phrase_candidates.batch": (1000.0, "phrase.candidates"),
    "lazy_chunks.batch": (2.5, "phrase.lazy_chunks"),
    "phrase_syncs.batch": (3.0, "phrase.syncs"),
}


def _run():
    spans = {
        "exec.group.lazyph": {"total_ms": 6.0, "count": 8, "avg_us": 750.0},
        "phrase.candidates": {"total_ms": 0.0, "count": 4000, "avg_us": 0.0},
        "phrase.lazy_chunks": {"total_ms": 0.0, "count": 10, "avg_us": 0.0},
        "phrase.syncs": {"total_ms": 0.0, "count": 12, "avg_us": 0.0},
        "exec.phrase": {"total_ms": 5.0, "count": 8, "avg_us": 625.0},
    }
    return SimpleNamespace(batches=4, searches=0, program_spans=spans)


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_value_and_missing_counter(name):
    value, span = READS[name]
    read = harness.load_file("metrics", name).read
    assert read(_run()) == pytest.approx(value)
    run = _run()
    del run.program_spans[span]
    assert read(run) is None
    run = _run()
    run.batches = 0
    assert read(run) is None


def _tiny():
    cell = tiny_cell(CELL, docs=2048, vocab=2048)
    cell.traffic = dict(cell.traffic, pool_batches=3)
    return cell


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_tiny_run_is_correct_on_the_lazy_route(trace, monkeypatch):
    monkeypatch.setattr(profiling, "traced", stand_in_profiler)
    cell = _tiny()
    lines = []
    res = harness.run_cell(cell, 2**31 + 151, 0.5, trace, "cpu",
                           time.perf_counter(), lines.append)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    spans = timings.get_tracer().snapshot()
    assert spans["exec.group.lazyph"]["count"] > 0
    assert "exec.group.posph" not in spans
    if not trace:
        # device_peak_gib reads the card's allocator: none on the CPU
        assert set(res["metrics"]) == {"qps", "batch_p95_ms", "setup_s"}
        return
    assert {m["name"] for m in cell.per_layer} == set(res["metrics"])
    for m in READS:
        assert res["metrics"][m]["value"] > 0, m
