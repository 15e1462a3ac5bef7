"""Twin of tests/test_flat.py: the flat boolean path on the port's CPU
executor. The flattener rules (the port's copy of _flatten_tape, which
tests/test_torch_host.py holds to the original by source) and the batch
cases (:125-166): engine-vs-oracle parity through the flat path, the flat
path equal to the tape path, mixed flat shapes in one group, and the
deletion registry."""

import numpy as np
import pytest

import trinity_tpu_torch.exec.executor as exmod
from test_flat import FLAT_QUERIES
from trinity_tpu.oracle import OracleCorpus, oracle_search
from trinity_tpu.query.parser import parse_query as jax_parse
from trinity_tpu_torch import Executor, SegmentIndexSession
from trinity_tpu_torch.plan.compile import compile_plan
from trinity_tpu_torch.query.parser import parse_query

RTOL = 2.4e-7  # 2 ulp


def _flat(qtext):
    p = compile_plan(parse_query(qtext).root)
    return exmod._flatten_tape(p.tape, p.n_slots)


@pytest.mark.parametrize("qtext,flags,kmin", [
    ("a b c", (1, 1, 1), 3), ("a OR b OR c", (1, 1, 1), 1),
    ("a b NOT c", (1, 1, 2), 2), ("a NOT (b OR c)", (1, 2, 2), 1),
    ("[a, b, c]", (1, 1, 1), 1), ("a <b>", (1, 4), 1),
    ("(a b) OR (c d)", None, None), ("a NOT (b c)", None, None),
])
def test_flattener_rules(qtext, flags, kmin):
    got = _flat(qtext)
    if flags is None:
        assert got is None
        return
    fl, wsel, km = got
    assert fl == flags and km == kmin
    if qtext == "a b NOT c":
        assert wsel[2] == -1  # negated slots are unscored


def test_flatten_rejects_slot_reuse():
    assert exmod._flatten_tape(("or", ("tok", 0, 0), ("tok", 0, 1)),
                               1) is None


def make_corpus(rng, n_docs, vocab):
    """The original's corpus (the same draws), indexed by the port."""
    sess = SegmentIndexSession()
    corpus = OracleCorpus()
    zipf = 1.0 / np.arange(1, vocab + 1)
    zipf /= zipf.sum()
    for d in range(n_docs):
        doc_id = d * 3 + 2
        length = int(rng.integers(4, 30))
        toks = [f"t{int(i)}" for i in rng.choice(vocab, size=length, p=zipf)]
        corpus.add(doc_id, toks)
        p = sess.begin(doc_id)
        for pos, t in enumerate(toks, start=1):
            p.insert(t, pos)
        sess.insert(p)
    return sess.commit(), corpus


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(23)
    seg, corpus = make_corpus(rng, n_docs=500, vocab=90)
    return Executor(seg, "cpu"), corpus


def test_flat_batch_vs_oracle(small):
    ex, corpus = small
    assert {g.kind for g in ex.plan_batch(FLAT_QUERIES)} == {"flat"}
    outs = ex.search_batch(FLAT_QUERIES, k=10)
    for qtext, res in zip(FLAT_QUERIES, outs):
        want = oracle_search(corpus, jax_parse(qtext).root, k=10)
        assert [r.doc_id for r in res] == [w[0] for w in want], qtext
        got = np.array([r.score for r in res], np.float32)
        exp = np.array([w[1] for w in want], np.float32)
        np.testing.assert_allclose(got, exp, rtol=RTOL, atol=0)


def test_flat_matches_tape_path(small, monkeypatch):
    """With the flattener refusing every tape, the same queries run as
    tape (K3) and dense groups and give the flat path's results."""
    ex, corpus = small
    flat_out = ex.search_batch(FLAT_QUERIES, k=10)
    monkeypatch.setattr(exmod, "_flatten_tape", lambda tape, n: None)
    assert "flat" not in {g.kind for g in ex.plan_batch(FLAT_QUERIES)}
    tape_out = ex.search_batch(FLAT_QUERIES, k=10)
    for a, b in zip(flat_out, tape_out):
        assert [r.doc_id for r in a] == [r.doc_id for r in b]
        np.testing.assert_allclose([r.score for r in a],
                                   [r.score for r in b], rtol=RTOL, atol=0)


def test_mixed_shapes_one_group(small):
    """AND and NOT queries (same T bucket) share one flat group: one
    kernel launch for both shapes."""
    ex, corpus = small
    qs = ["t0 t1", "t2 t3", "t1 NOT t2", "t4 NOT t0"]
    handle = ex.launch_batch(qs, k=5)
    groups = handle[0]
    assert [g.kind for g in groups] == ["flat"]
    assert len(groups[0].members) == 4  # all four queries in the one group
    outs = ex.finish_batch(handle)
    for qtext, res in zip(qs, outs):
        want = oracle_search(corpus, jax_parse(qtext).root, k=5)
        assert [r.doc_id for r in res] == [w[0] for w in want]


def test_flat_respects_deletions(small):
    ex, corpus = small
    out0 = ex.search_batch(["t0 t1"], k=5)[0]
    assert out0, "need matches to delete"
    victim = out0[0].doc_id
    ex.set_masked_local_docs(
        np.array([np.flatnonzero(ex.seg.doc_map == victim)[0]], np.int64)
    )
    try:
        out1 = ex.search_batch(["t0 t1"], k=5)[0]
        assert victim not in [r.doc_id for r in out1]
    finally:
        ex.set_masked_local_docs(np.array([], np.int64))
