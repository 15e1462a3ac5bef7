"""A small cell through the harness on the card, traced (run on the chip)."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["abstracts1m.mix.batch",
                                  "abstracts1m.mix.search",
                                  "abstracts1m-3gen.mix.batch"])
def test_traced_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = tiny_cell(name, docs=65536, vocab=65536)
    res = harness.run_cell(cell, 2**31 + 3, 2.0, True, "cuda:0",
                           time.perf_counter(), lambda m: None)
    assert res["correct"], res["checks"]
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert {m["name"] for m in cell.per_layer} == set(res["metrics"])
    roof = res["metrics"].get("kernels_roofline.batch")
    assert roof is None or 0 < roof["value"] <= 100
    for m, v in res["metrics"].items():
        if m.startswith("device_idle."):
            assert 0 <= v["value"] < 100, (m, v)
    assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]
