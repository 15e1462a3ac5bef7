"""The harness loads no JAX, fails without a card, and fails without the port."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT
RUN = [sys.executable, "benchmark/run.py", "--workload",
       "abstracts1m.mix.batch", "--seed", "5", "--seconds", "1"]

# a tiny CPU run in a fresh process, then every loaded module's name
PROBE = """
import json, sys, time
sys.path.insert(0, {root!r})
import benchmark.run, benchmark.control
from benchmark import harness
from benchmark.tests.tiny import tiny_cell
cell = tiny_cell(docs=2048, vocab=2048)
for m in cell.end_to_end + cell.per_layer:
    harness.load_file("metrics", m["name"])
harness.run_cell(cell, 3, 0.5, False, "cpu", time.perf_counter(),
                 lambda m: None)
print(json.dumps(sorted(sys.modules)))
"""


def test_no_jax_module_loads():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT)],
                         capture_output=True, text=True, check=True,
                         timeout=600)
    names = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {n.split(".")[0] for n in names}
    assert "trinity_tpu_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "trinity_tpu"}


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "trinity_tpu_torch_extra", object())
    assert "trinity_tpu_torch_extra" not in harness.jax_modules()
    monkeypatch.setitem(sys.modules, "trinity_tpu.oracle", object())
    assert harness.jax_modules() == ["trinity_tpu.oracle"]


def test_no_card_fails_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(RUN, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no card" in r.stderr


def test_bare_checkout_fails_without_a_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    r = subprocess.run(RUN, cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
