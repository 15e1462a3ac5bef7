"""Twin of tests/test_exec_e2e.py: the port's CPU executor against the
oracle (trinity_tpu/oracle.py), end to end, on corpora drawn as the
original draws them (the same seeds), indexed by the port's builder:
top-k parity on every query and scorer, match_ids, a three-window corpus,
masked documents, the docid-ascending tie-break, and search_batch /
search_many equal to search. Ids exactly, scores within 2 ulp."""

import numpy as np
import pytest

from test_exec_e2e import QUERIES
from trinity_tpu.oracle import OracleCorpus, oracle_match_ids, oracle_search
from trinity_tpu.query.parser import parse_query as jax_parse
from trinity_tpu_torch import Executor, SegmentIndexSession

RTOL = 2.4e-7  # 2 ulp


def make_corpus(rng, n_docs, vocab, doc_len_rng, id_stride=1):
    """The original's make_corpus (the same draws), indexed by the port:
    (port segment, oracle corpus)."""
    sess = SegmentIndexSession()
    corpus = OracleCorpus()
    zipf = 1.0 / np.arange(1, vocab + 1)
    zipf /= zipf.sum()
    for d in range(n_docs):
        doc_id = d * id_stride + 3
        length = int(rng.integers(*doc_len_rng))
        toks = [f"t{int(i)}" for i in rng.choice(vocab, size=length, p=zipf)]
        corpus.add(doc_id, toks)
        p = sess.begin(doc_id)
        for pos, t in enumerate(toks, start=1):
            p.insert(t, pos)
        sess.insert(p)
    return sess.commit(), corpus


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(7)
    seg, corpus = make_corpus(rng, n_docs=600, vocab=120, doc_len_rng=(4, 40),
                              id_stride=5)
    return Executor(seg, "cpu"), corpus


def ids(results):
    return [r.doc_id for r in results]


def assert_parity(got, want, what):
    assert ids(got) == [d for d, _ in want], f"{what} ids"
    np.testing.assert_allclose([r.score for r in got], [s for _, s in want],
                               rtol=RTOL, atol=0, err_msg=what)


@pytest.mark.parametrize("qtext", QUERIES)
@pytest.mark.parametrize("scorer", ["bm25", "tfidf", "trivial"])
def test_topk_parity_small(small, qtext, scorer):
    ex, corpus = small
    got = ex.search(qtext, k=10, scorer=scorer)
    want = oracle_search(corpus, jax_parse(qtext).root, k=10, scorer=scorer)
    assert_parity(got, want, qtext)


@pytest.mark.parametrize("qtext", QUERIES[:10])
def test_match_ids_parity(small, qtext):
    ex, corpus = small
    want = oracle_match_ids(corpus, jax_parse(qtext).root)
    np.testing.assert_array_equal(ex.match_ids(qtext),
                                  np.array(want, np.uint32))


@pytest.fixture(scope="module")
def multiwindow():
    """> 1 window (n_docs > 16384): window tiling and the merge."""
    rng = np.random.default_rng(11)
    seg, corpus = make_corpus(rng, n_docs=40_000, vocab=4000,
                              doc_len_rng=(3, 9), id_stride=2)
    assert seg.n_windows == 3
    return Executor(seg, "cpu"), corpus


@pytest.mark.parametrize(
    "qtext",
    ["t0", "t1 t2", "t3 OR t7 OR t19", "t2 NOT t5", "[t5, t9, t31]"],
)
def test_topk_parity_multiwindow(multiwindow, qtext):
    ex, corpus = multiwindow
    got = ex.search(qtext, k=10, scorer="bm25")
    want = oracle_search(corpus, jax_parse(qtext).root, k=10, scorer="bm25")
    assert_parity(got, want, qtext)


def test_masked_docs(small):
    ex, corpus = small
    ex.set_masked_local_docs(np.arange(50))  # the first 50 local docs
    try:
        masked_app = set(int(a) for a in ex.seg.doc_map[:50])
        got = ex.search("t0 OR t1", k=10)
        want = oracle_search(corpus, jax_parse("t0 OR t1").root, k=10,
                             masked=masked_app)
        assert_parity(got, want, "masked")
    finally:
        ex.set_masked_local_docs(None)


def test_tie_break_is_docid_ascending():
    """Equal-score docs rank by ascending doc id."""
    sess = SegmentIndexSession()
    for d in range(30):
        p = sess.begin(d + 1)
        for pos, t in enumerate(["same", "same", "other"], start=1):
            p.insert(t, pos)
        sess.insert(p)
    got = Executor(sess.commit(), "cpu").search("same", k=10)
    assert ids(got) == list(range(1, 11))
    assert len({r.score for r in got}) == 1


def test_search_batch_parity(small):
    ex, _ = small
    qs = ["t0 t1", "t2 t3", "t1 t5", "t0 OR t9", "t3 OR t1", '"t0 t1"', "zzz",
          "t4 NOT t0"]
    for q, br in zip(qs, ex.search_batch(qs, k=10)):
        assert br == ex.search(q, k=10), q


def test_search_many_parity(small):
    ex, _ = small
    qs = ["t0 t1", "t2 OR t3", '"t0 t1"', "zzz"]
    for q, mr in zip(qs, ex.search_many(qs, k=10)):
        assert mr == ex.search(q, k=10), q
