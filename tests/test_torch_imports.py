"""The port stands without JAX, and never hides a missing device.

- In a subprocess where ``import jax`` fails (``sys.modules["jax"] =
  None``), ``import trinity_tpu_torch`` works and a tiny CPU search runs
  and agrees with the oracle, phrases included (posmask, lazy and
  compound paths), and every module of the port imports.
- No source file of the port imports jax or ``trinity_tpu.ops``.
- ``Executor(seg, device="cuda")`` raises when torch sees no card, and a
  kernel build without nvcc raises instead of falling back.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from trinity_tpu.index.builder import SegmentIndexSession
from trinity_tpu_torch import Executor
from trinity_tpu_torch.utils import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import trinity_tpu_torch
from trinity_tpu_torch import Executor, SegmentIndexSession, parse_query
from trinity_tpu.oracle import OracleCorpus, oracle_search

docs = {1: "a b c a", 2: "b c", 3: "a c d", 4: "d d a", 5: "b"}
sess, oc = SegmentIndexSession(), OracleCorpus()
for d, text in docs.items():
    p = sess.begin(d)
    for pos, t in enumerate(text.split(), start=1):
        p.insert(t, pos)
    sess.insert(p)
    oc.add(d, text.split())
ex = Executor(sess.commit(), device="cpu")
qs = ("a c", "a OR d", "c NOT b", "(a b) OR (c d)", '"a b"', '"b c" OR d',
      '"c a" a')
for q in qs:
    got = [(r.doc_id, r.score) for r in ex.search(q, k=3)]
    want = oracle_search(oc, parse_query(q).root, k=3)
    assert [d for d, _ in got] == [d for d, _ in want], (q, got, want)
trinity_tpu_torch.configure(use_posmask=False)
ex = Executor(ex.seg, device="cpu")
assert [r.doc_id for r in ex.search('"a b"')] == [1]
import trinity_tpu_torch.exec.phrases, trinity_tpu_torch.ops.posmask
import trinity_tpu_torch.ops.select, trinity_tpu_torch.utils.kernels
assert sys.modules["jax"] is None
print("OK")
"""


def test_port_imports_and_searches_without_jax():
    r = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("OK")


def test_port_sources_import_no_jax_and_no_reference_ops():
    """No module of the port imports jax or a trinity_tpu.ops module (the
    reference's ops modules hold its Pallas kernels)."""
    import ast

    pkg = os.path.join(REPO, "trinity_tpu_torch")
    # the port's sources; _build holds build outputs, not sources
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")
             and "_build" not in os.path.relpath(d, pkg).split(os.sep)]
    assert len(files) >= 12
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] != "jax", (path, n)
                assert not n.startswith("trinity_tpu.ops"), (path, n)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the host code through trinity_tpu_torch: it
    imports neither jax nor any trinity_tpu module."""
    import ast

    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert "trinity_tpu_torch" in names
    for n in names:
        assert n.split(".")[0] not in ("jax", "trinity_tpu"), n


def _tiny_segment():
    sess = SegmentIndexSession()
    p = sess.begin(1)
    p.insert("a", 1)
    sess.insert(p)
    return sess.commit()


def test_cuda_executor_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        Executor(_tiny_segment(), device="cuda")


def test_unknown_device_raises():
    with pytest.raises(ValueError):
        Executor(_tiny_segment(), device="meta")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
    assert not (tmp_path / "build").exists()


def test_cpu_wrappers_count_no_launch():
    """On CPU tensors the wrappers run the plain versions: no kernel
    launch is counted."""
    seg = _tiny_segment()
    before = dict(kernels.launches)
    ex = Executor(seg, device="cpu")
    assert [r.doc_id for r in ex.search("a")] == [1]
    assert kernels.launches == before
    assert np.asarray(ex.planes).dtype == np.int32
