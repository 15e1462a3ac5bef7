"""`correct` comes out false for the control and for a broken timed path.

The control is the reference computed in bfloat16 put in the program's
place. The faults a search cell can have are planted under a whole run of
the harness on the CPU (the port's plain versions stand in for the card):
half of every batch's answers left out, and an answer altered where it is
produced. (A state left unchanged is a training step's fault; there is no
exchange between chips in a one-card cell.)
"""

import time

import pytest

from benchmark import compare, corpus, harness
from benchmark.control import control_numbers
from benchmark.tests.tiny import tiny_cell

CELLS = ["abstracts1m.mix.batch", "abstracts1m.mix.search",
         "abstracts1m-3gen.mix.batch"]


class Broken:
    """The system with its answers broken as `fault` says."""

    def __init__(self, system, fault):
        self.system, self.fault, self.calls = system, fault, 0

    def warmup(self, *a, **kw):
        return self.system.warmup(*a, **kw)

    def launch_batch(self, queries, **kw):
        return self.system.launch_batch(queries, **kw)

    def finish_batch(self, handle):
        return [self.broken(r) for r in self.system.finish_batch(handle)]

    def search(self, query, **kw):
        return self.broken(self.system.search(query, **kw))

    def broken(self, res):
        self.calls += 1
        if self.fault == "half_left_out" and self.calls % 2:
            return []
        if self.fault == "answer_altered" and res and self.calls % 7 == 0:
            r = res[0]
            res = [type(r)(r.doc_id + 1, r.score)] + res[1:]
        return res


def run(cell, fault, monkeypatch):
    build = corpus.build_system
    if fault is not None:
        monkeypatch.setattr(
            corpus, "build_system",
            lambda *a, **kw: (lambda s: (Broken(s[0], fault), s[1]))(
                build(*a, **kw)))
    return harness.run_cell(cell, 77, 1.0, False, "cpu", time.perf_counter(),
                            lambda m: None)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, monkeypatch):
    res = run(tiny_cell(name), None, monkeypatch)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["checks"]["topk_gap"]["value"] < 1e-6


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    res = run(tiny_cell(name), fault, monkeypatch)
    assert not res["correct"], res["checks"]
    failing = {n for n, c in res["checks"].items() if c["value"] > c["limit"]}
    assert failing & {"answer_faults", "topk_gap", "tie_faults"}


@pytest.mark.parametrize("name", ["abstracts1m.mix.batch",
                                  "abstracts1m-3gen.mix.batch"])
def test_control_in_bfloat16_is_not_correct(name):
    nums = control_numbers(tiny_cell(name), 11, "cpu")
    assert not compare.correct(nums)
    assert nums["topk_gap"] > 10 * compare.LIMITS["topk_gap"]
