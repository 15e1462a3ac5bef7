"""The port stands alone, without JAX and without the JAX package, and
never hides a missing device.

- In a subprocess where ``import jax`` fails (``sys.modules["jax"] =
  None``) and a meta-path finder refuses ``trinity_tpu`` and every
  ``trinity_tpu.*``, every module of the port imports and a tiny CPU
  search runs, phrases included (posmask, lazy and compound paths), and
  so do a two-generation collection (search, pruned search, match_ids
  through ``exec_query``), the merge, ``doc_set``, the metrics,
  rich-match (``exec_rich``), ``intersect``, ``rewrite_query``, a
  threaded warmup with the seal, a percolator ``match_batch`` and a
  two-shard mesh search (``MeshExecutor``, ``MeshSourcesCollection``);
  no ``trinity_tpu`` module is loaded. Only then is the finder removed and the
  oracle (``trinity_tpu.oracle``, with the JAX package's parser) imported,
  and the results must agree with it.
- No source file of the port, and not chip_smoke.py, imports jax or
  ``trinity_tpu`` / ``trinity_tpu.*``.
- ``Executor(seg)`` runs on the card by default: without one it raises,
  as ``Executor(seg, device="cuda")`` does; a kernel build without nvcc
  raises instead of falling back.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from trinity_tpu_torch import Executor, SegmentIndexSession
from trinity_tpu_torch.utils import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = r"""
import importlib, os, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError


class Refuse:  # refuses the JAX package: trinity_tpu and trinity_tpu.*
    def find_spec(self, name, path=None, target=None):
        if name == "trinity_tpu" or name.startswith("trinity_tpu."):
            raise ImportError(f"refused: {name}")
        return None


refuse = Refuse()
sys.meta_path.insert(0, refuse)
import trinity_tpu_torch
from trinity_tpu_torch import Executor, SegmentIndexSession, configure

pkg = os.path.dirname(trinity_tpu_torch.__file__)
names = [m.name for m in pkgutil.walk_packages([pkg], "trinity_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 25, names

docs = {1: "a b c a", 2: "b c", 3: "a c d", 4: "d d a", 5: "b"}
sess = SegmentIndexSession()
for d, text in docs.items():
    p = sess.begin(d)
    for pos, t in enumerate(text.split(), start=1):
        p.insert(t, pos)
    sess.insert(p)
ex = Executor(sess.commit(), device="cpu")
qs = ("a c", "a OR d", "c NOT b", "(a b) OR (c d)", '"a b"', '"b c" OR d',
      '"c a" a')
got = {q: [r.doc_id for r in ex.search(q, k=3)] for q in qs}
configure(use_posmask=False)
lazy = [r.doc_id for r in Executor(ex.seg, device="cpu").search('"a b"')]
configure(use_posmask=True)
# the collection, the merge, match_ids, doc_set and pruned search
from trinity_tpu_torch import (ExecFlags, IndexSourcesCollection,
                               MergeCandidatesCollection, exec_query,
                               get_metrics)
sess = SegmentIndexSession()
p = sess.begin(2)
for pos, t in enumerate("a d".split(), start=1):
    p.insert(t, pos)
sess.update(p)
sess.erase(4)
newer = sess.commit()
coll = IndexSourcesCollection(device="cpu").add_segment(ex.seg, 1)
coll = coll.add_segment(newer, 2).commit()
mc = MergeCandidatesCollection()
mc.insert(ex.seg, 1)
mc.insert(newer, 2)
merged = Executor(mc.merge(keep_updated_ids=False), device="cpu")
stats = dict(stats=coll.aggregated_stats(), df_of=coll.doc_freq)
coll_hits = [(r.doc_id, r.score) for r in coll.search("a OR d", k=5)]
assert coll_hits == [(r.doc_id, r.score)
                     for r in merged.search("a OR d", k=5, **stats)]
assert coll_hits == [(r.doc_id, r.score)
                     for r in coll.search_pruned("a OR d", k=5)]
assert list(exec_query("a", coll, flags=ExecFlags.DOCUMENTS_ONLY)) == [1, 2, 3]
assert list(ex.match_ids("a", doc_set=[1, 4])) == [1, 4]
assert get_metrics().snapshot()["pruned.rounds"]["value"] > 0
# rich-match, intersect, rewrite, threaded warmup and the seal
from trinity_tpu_torch import (Alternative, exec_rich, parse_query,
                               rewrite_query)
from trinity_tpu_torch.query.intersect import intersect
from trinity_tpu_torch.utils.seal import (post_seal_misses, seal_programs,
                                          unseal_programs)
rich = []
exec_rich(ex, '"a b" OR d', lambda md: rich.append(
    (md.doc_id, [(t.term, [h.pos for h in t.hits]) for t in md.matched_terms])))
assert rich == [(1, [("a", [1, 4]), ("b", [2])]), (3, [("a", [1]), ("d", [3])]),
                (4, [("a", [3]), ("d", [1, 2])])], rich
assert intersect(ex, ["a", "c"]) == [(3, 2)]  # {a}, {c} dominated
assert "e" in str(rewrite_query(parse_query("a"),
                                lambda w: [Alternative(["e"])]))
assert ex.warmup(qs, threads=4)["variants"] == len(qs) + 1
seal_programs(strict=True)
ex.search_batch(qs)
assert post_seal_misses() == 0
unseal_programs()
# the percolator and a two-shard mesh
from trinity_tpu_torch import Percolator
from trinity_tpu_torch.parallel import MeshExecutor, MeshSourcesCollection
perc = Percolator(device="cpu")
for q in ('a c', '"b c" OR d', '[a, b, d]/2'):
    perc.register(q)
perc_m = perc.match_batch([text.split() for text in docs.values()])
mex = MeshExecutor(ex.seg, devices="cpu", n_shards=2)
assert [s.n_docs for s in mex.shards] == [5, 0]
mesh_hits = {q: [r.doc_id for r in mex.search(q, k=3)] for q in qs}
assert mesh_hits == got, (mesh_hits, got)
meshc = MeshSourcesCollection(devices="cpu", n_shards=2)
meshc = meshc.add_segment(ex.seg, 1).add_segment(newer, 2).commit()
assert [(r.doc_id, r.score) for r in meshc.search("a OR d", k=5)] == coll_hits
loaded = [m for m in sys.modules
          if m == "trinity_tpu" or m.startswith("trinity_tpu.")]
assert not loaded, loaded
assert sys.modules["jax"] is None
sys.meta_path.remove(refuse)

from trinity_tpu.oracle import OracleCorpus, oracle_search
from trinity_tpu.query.parser import parse_query

oc = OracleCorpus()
for d, text in docs.items():
    oc.add(d, text.split())
for q in qs:
    want = [d for d, _ in oracle_search(oc, parse_query(q).root, k=3)]
    assert got[q] == want, (q, got[q], want)
assert lazy == [1]
from trinity_tpu.oracle import oracle_match_ids
for qi, q in enumerate(('a c', '"b c" OR d', '[a, b, d]/2')):
    ids = [d for d, hit in zip(docs, perc_m[:, qi]) if hit]
    assert ids == oracle_match_ids(oc, parse_query(q).root), (q, ids)
print("OK")
"""


def test_port_imports_and_searches_without_jax():
    r = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("OK")


def _imported_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def _refused(name):
    top = name.split(".")[0]
    return top in ("jax", "trinity_tpu")


def test_port_sources_import_no_jax_and_no_reference_ops():
    """No module of the port imports jax or any trinity_tpu module (the
    name is kept from when only the reference's ops modules were
    refused)."""
    pkg = os.path.join(REPO, "trinity_tpu_torch")
    # the port's sources; _build holds build outputs, not sources
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")
             and "_build" not in os.path.relpath(d, pkg).split(os.sep)]
    assert len(files) >= 25
    rel = {os.path.relpath(p, pkg) for p in files}
    assert {"exec/pruned.py", "exec/residency.py", "index/source.py",
            "index/merge.py", "utils/metrics.py", "utils/timings.py",
            "percolator.py", "parallel/mesh.py"} <= rel
    for path in files:
        for n in _imported_names(path):
            assert not _refused(n), (path, n)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the host code through trinity_tpu_torch: it
    imports neither jax nor any trinity_tpu module."""
    names = list(_imported_names(os.path.join(REPO, "chip_smoke.py")))
    assert "trinity_tpu_torch" in names
    for n in names:
        assert not _refused(n), n


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


def test_default_device_is_the_card():
    """Executor(seg) with no device asks for the card, so on a host
    without one it raises rather than running on the CPU."""
    if torch.cuda.is_available():
        assert Executor(_tiny_segment()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="is_available"):
        Executor(_tiny_segment())


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
