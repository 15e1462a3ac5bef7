"""The port's other entry points of one segment against the JAX package.

On a one-window corpus with positions and a deletion registry, made from a
numpy seed and built by both packages' builders (held equal), the port's
CPU executor against the JAX Executor (interpret mode, as the JAX
package's own tests run it on the CPU) and the oracle:

- ``match_ids`` (DocumentsOnly) on every route a query can take: flat
  (K2's plain version), OR-of-AND (K3's), more than 8 slots (K1 + the
  tape in torch), a pure phrase on the posmask path and with posmask off
  (the compound path), phrases inside trees (the compound path);
- ``doc_set`` on ``search`` and ``match_ids``, on top of the registry;
- collection statistics (``stats``, ``df_of``) reaching the weights of
  every group kind (flat, fused, dense, posmask, lazy and compound
  phrases);
- ``launch`` / ``finish``, ``search_many`` and the ``exec_query`` facade
  (a segment, an executor, a collection; ranked and DOCUMENTS_ONLY);
- the spans and counters, by the reference's names.

Ids exactly, scores within 2 ulp.
"""

import dataclasses

import numpy as np
import pytest
import torch

import trinity_tpu as jax_pkg
import trinity_tpu_torch as port_pkg
from torch_twins import docs_pair, reconfigured
from trinity_tpu.exec import Executor as JaxExecutor
from trinity_tpu.oracle import OracleCorpus, oracle_match_ids, oracle_search
from trinity_tpu.query.parser import parse_query
from trinity_tpu_torch import ExecFlags, Executor, IndexSourcesCollection
from trinity_tpu_torch.index.format import FieldStatistics

RTOL = 2.4e-7  # 2 ulp

BOOLEAN = ["t0 t1", "t3 OR t4", "t2 NOT t0", "[t1, t5, t9]/2",
           "(t0 t9) OR (t3 t12)", " OR ".join(f"t{i}" for i in range(10, 21))]
PHRASES = ['"t0 t1"', '"t5 t6 t7"', '"t2 t2"']
COMPOUND = ['"t0 t1" OR t5', 't3 "t0 t1"', 't9 NOT "t5 t6"']
ALL = BOOLEAN + PHRASES + COMPOUND


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(17)
    zipf = 1.0 / np.arange(1, 31)
    zipf /= zipf.sum()
    docs = {}
    for d in range(1, 901):
        toks = [f"t{int(i)}" for i in rng.choice(
            30, size=int(rng.integers(6, 40)), p=zipf)]
        r = rng.random()
        if r < 0.3:
            toks[2:4] = ["t0", "t1"]
        if 0.2 < r < 0.5:
            toks[0:3] = ["t5", "t6", "t7"]
        if r > 0.8:
            toks[1:3] = ["t2", "t2"]
        docs[3 * d] = toks
    seg, ref_seg = docs_pair(docs)
    assert seg.positions_distinct
    oc = OracleCorpus()
    for d, toks in docs.items():
        oc.add(d, toks)
    masked = {d for d in docs if d % 7 == 0}
    local = np.flatnonzero(np.isin(seg.doc_map, sorted(masked)))
    return seg, ref_seg, oc, masked, local


@pytest.fixture(scope="module")
def pair(corpus):
    seg, ref_seg, _, _, local = corpus
    ex, jx = Executor(seg, device="cpu"), JaxExecutor(ref_seg)
    ex.set_masked_local_docs(local)
    jx.set_masked_local_docs(local)
    return ex, jx


def _pairs(res):
    return [(r.doc_id, r.score) for r in res]


def _same(got, want, what):
    assert [d for d, _ in got] == [d for d, _ in want], what
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=RTOL, atol=0, err_msg=what)


def test_match_ids_routes(pair):
    """Each query's plan takes the route the docstring names."""
    ex, _ = pair
    kinds = [ex.plan_batch([q], k=1)[0].kind for q in ALL]
    assert kinds == ["flat"] * 4 + ["fused", "dense"] + ["posph"] * 3 + [
        "phrase"] * 3


@pytest.mark.parametrize("qtext", ALL)
def test_match_ids_equals_jax_and_oracle(pair, corpus, qtext):
    ex, jx = pair
    _, _, oc, masked, _ = corpus
    got = ex.match_ids(qtext)
    want = jx.match_ids(qtext)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want, err_msg=qtext)
    np.testing.assert_array_equal(
        got, np.array(oracle_match_ids(oc, parse_query(qtext).root, masked),
                      np.uint32), err_msg=qtext)
    assert len(got) > 0, qtext


@pytest.mark.parametrize("qtext", PHRASES)
def test_match_ids_phrase_without_posmask(corpus, pair, qtext):
    """With posmask off a pure phrase's mask comes from the compound path
    (every candidate verified)."""
    seg, _, oc, masked, local = corpus
    with reconfigured(use_posmask=False):
        ex = Executor(seg, device="cpu")
        ex.set_masked_local_docs(local)
        assert ex.plan_batch([qtext], k=1)[0].kind == "lazyph"
        got = ex.match_ids(qtext)
    np.testing.assert_array_equal(got, pair[0].match_ids(qtext))
    np.testing.assert_array_equal(got, pair[1].match_ids(qtext))


def test_match_ids_empty_and_unknown(pair):
    ex, _ = pair
    for q in ("", "zz", '"zz t0"'):
        got = ex.match_ids(q)
        assert got.dtype == np.uint32 and len(got) == 0, q


@pytest.mark.parametrize("qtext", ["t0 t1", "(t0 t9) OR (t3 t12)",
                                   '"t0 t1"', 't3 "t0 t1"'])
def test_doc_set_equals_jax(pair, qtext):
    """doc_set restricts search and match_ids on top of the registry, and
    the registry is back in place afterwards."""
    ex, jx = pair
    ids = ex.match_ids(qtext)
    doc_set = np.concatenate([ids[::2], [1, 2, 10**6]])  # and absent ids
    before = ex._deleted_np.copy()
    got = ex.search(qtext, k=10, doc_set=doc_set)
    want = jx.search(qtext, k=10, doc_set=doc_set)
    assert len(want) > 0
    _same(_pairs(got), _pairs(want), qtext)
    assert {r.doc_id for r in got} <= set(ids[::2].tolist())
    m = ex.match_ids(qtext, doc_set=doc_set)
    np.testing.assert_array_equal(m, jx.match_ids(qtext, doc_set=doc_set))
    np.testing.assert_array_equal(m, ids[::2])
    np.testing.assert_array_equal(ex._deleted_np, before)
    _same(_pairs(ex.search(qtext, k=10)), _pairs(jx.search(qtext, k=10)),
          qtext)


def test_collection_stats_reach_every_group_kind(corpus, pair):
    """search_batch with stats / df_of (as a collection passes them) equals
    the JAX executor's with the same numbers, on flat, fused, dense,
    posmask-phrase and compound groups, and on the lazy phrase path."""
    seg, ref_seg, _, _, local = corpus
    ex, jx = pair
    df_of = lambda t: 3 * int(seg.term_df[seg.term_id(t)]) + 11
    stats = FieldStatistics(docs_cnt=7 * seg.n_docs)
    ref_stats = type(ref_seg.stats)(docs_cnt=7 * seg.n_docs)
    got = ex.search_batch(ALL, k=10, stats=stats, df_of=df_of)
    want = jx.search_batch(ALL, k=10, stats=ref_stats, df_of=df_of)
    own = ex.search_batch(ALL, k=10)
    for q, g, w, o in zip(ALL, got, want, own):
        assert len(w) > 0, q
        _same(_pairs(g), _pairs(w), q)
        assert [r.score for r in g] != [r.score for r in o], q
    with reconfigured(use_posmask=False):
        lazy = Executor(seg, device="cpu")
        lazy.set_masked_local_docs(local)
        assert {g.kind for g in lazy.plan_batch(PHRASES)} == {"lazyph"}
        for q, g, w in zip(PHRASES, lazy.search_batch(
                PHRASES, k=10, stats=stats, df_of=df_of), want[6:9]):
            _same(_pairs(g), _pairs(w), q)


def test_launch_finish_and_search_many(pair):
    """launch returns before finish reads the device; its handle's results
    equal the JAX pair's (one query) and search()'s (each route)."""
    ex, jx = pair
    q = "t3 OR t4"
    _same(_pairs(ex.finish(ex.launch(q, k=10))),
          _pairs(jx.finish(jx.launch(q, k=10))), q)
    handles = [ex.launch(q, k=10) for q in ALL]  # all launched, then read
    for q, h in zip(ALL, handles):
        assert _pairs(ex.finish(h)) == _pairs(ex.search(q, k=10)), q
    assert ex.launch("") is None and ex.finish(None) == []
    got = ex.search_many(ALL, k=10)
    for q, g, w in zip(ALL, got, jx.search_many(ALL, k=10)):
        _same(_pairs(g), _pairs(w), q)
    assert got == ex.search_batch(ALL, k=10)


def test_exec_query_facade(corpus):
    """exec_query on a segment (a new executor on the device asked for),
    an executor and a collection, ranked and DOCUMENTS_ONLY, equals the
    JAX package's facade."""
    seg, ref_seg, _, _, _ = corpus
    ex = Executor(seg, device="cpu")
    coll = IndexSourcesCollection(device="cpu").add_segment(seg, 5).commit()
    ref_coll = jax_pkg.IndexSourcesCollection().add_segment(ref_seg, 5)
    ref_coll.commit()
    for q in ("t0 t1", '"t5 t6 t7"'):
        want = jax_pkg.exec_query(q, ref_seg)
        for src in (seg, ex, coll):
            _same(_pairs(port_pkg.exec_query(q, src, device="cpu")),
                  _pairs(want), q)
        ids = jax_pkg.exec_query(q, ref_coll,
                                 flags=jax_pkg.ExecFlags.DOCUMENTS_ONLY)
        for src in (seg, ex, coll):
            np.testing.assert_array_equal(port_pkg.exec_query(
                q, src, flags=ExecFlags.DOCUMENTS_ONLY, device="cpu"), ids)
    assert [(f.name, f.value) for f in ExecFlags] == [
        (f.name, f.value) for f in jax_pkg.ExecFlags]
    assert dataclasses.asdict(FieldStatistics(docs_cnt=3)) == (
        dataclasses.asdict(type(ref_seg.stats)(docs_cnt=3)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            port_pkg.exec_query("t0", seg)  # the card by default


def test_search_with_stats_equals_oracle(corpus, pair):
    """A collection's docs_cnt and df reach the oracle's weights too."""
    seg, _, oc, masked, _ = corpus
    ex, _ = pair
    df_of = lambda t: 2 * int(seg.term_df[seg.term_id(t)])
    stats = FieldStatistics(docs_cnt=5 * seg.n_docs)
    for q in ("t0 t1", "t3 OR t4", '"t0 t1"'):
        want = oracle_search(oc, parse_query(q).root, k=10, masked=masked,
                             docs_cnt=stats.docs_cnt, df_of=df_of)
        _same(_pairs(ex.search(q, k=10, stats=stats, df_of=df_of)), want, q)


def test_spans_and_counters(corpus):
    """The executor's spans and counters carry the reference's names:
    exec.search / exec.prepare / exec.device, search.queries,
    search.batch_latency, phrase.host_verify (twin of test_api.py's
    tracer test)."""
    from trinity_tpu_torch import get_metrics
    from trinity_tpu_torch.utils.timings import get_tracer

    seg = corpus[0]
    with reconfigured(use_posmask=False):  # the pure phrase: a lazy group
        ex = Executor(seg, device="cpu")
    tracer, metrics = get_tracer(), get_metrics()
    tracer.reset()
    before = metrics.snapshot()
    count = lambda snap, name, key="value": snap.get(name, {}).get(key, 0)
    ex.search("t0 t1")
    ex._phrase_fcaps = lambda *a: None  # the host-verify routes
    ex.search_batch(['"t0 t1"', 't3 "t0 t1"'])
    snap = tracer.snapshot()
    assert all(snap[s]["count"] >= 1
               for s in ("exec.search", "exec.prepare", "exec.device"))
    after = metrics.snapshot()
    assert count(after, "search.queries") - count(before, "search.queries") == 3
    assert count(after, "search.batch_latency", "count") - count(
        before, "search.batch_latency", "count") == 2
    assert count(after, "phrase.host_verify") - count(
        before, "phrase.host_verify") == 2
