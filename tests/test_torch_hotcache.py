"""Twin of tests/test_hotcache.py: the port's hot-term planes (built by
the decode kernel's plain version on the CPU) give results bit-equal to
decoding every slot, with deletions and under a budget, and equal to the
oracle; the budget caps the cached set at the df top. The corpus is the
original's draw (same seed), indexed by the port's builder."""

import numpy as np
import pytest

from test_hotcache import QUERIES
from trinity_tpu.oracle import OracleCorpus, oracle_search
from trinity_tpu.query.parser import parse_query as jax_parse
from trinity_tpu_torch import Executor, SegmentIndexSession, configure, get_config


def make_corpus(rng, n_docs=2500, vocab=60):
    sess = SegmentIndexSession()
    corpus = OracleCorpus()
    zipf = 1.0 / np.arange(1, vocab + 1) ** 1.1
    zipf /= zipf.sum()
    for d in range(n_docs):
        length = int(rng.integers(4, 20))
        toks = [f"t{int(i)}" for i in rng.choice(vocab, size=length, p=zipf)]
        corpus.add(d, toks)
        p = sess.begin(d)
        for pos, t in enumerate(toks, start=1):
            p.insert(t, pos)
        sess.insert(p)
    return sess.commit(), corpus


@pytest.fixture(scope="module")
def seg_corpus():
    return make_corpus(np.random.default_rng(41))


@pytest.fixture()
def _restore_cfg():
    cfg = get_config()
    saved = (cfg.hot_cache_bytes, cfg.hot_cache_min_df)
    yield
    configure(hot_cache_bytes=saved[0], hot_cache_min_df=saved[1])


def executor(seg, **cfg):
    configure(**cfg)
    return Executor(seg, "cpu")


def _ids_scores(res):
    return [(r.doc_id, r.score) for r in res]


def test_cached_parity_exact(seg_corpus, _restore_cfg):
    """Cache on vs off: ids and f32 scores bit-identical, single and batch,
    with a partial cache (the Zipf head cached, the tail decoded)."""
    seg, _ = seg_corpus
    off = executor(seg, hot_cache_bytes=0)
    on = executor(seg, hot_cache_bytes=64 << 20, hot_cache_min_df=100)
    assert 0 < len(on._hot) < seg.n_terms
    for q in QUERIES:
        assert _ids_scores(off.search(q, k=10)) == _ids_scores(
            on.search(q, k=10)), q
    for a, b in zip(off.search_batch(QUERIES, k=10),
                    on.search_batch(QUERIES, k=10)):
        assert _ids_scores(a) == _ids_scores(b)


def test_cached_vs_oracle(seg_corpus, _restore_cfg):
    """Cache-on engine vs the oracle: ids exact, scores to 2 ulp."""
    seg, corpus = seg_corpus
    ex = executor(seg, hot_cache_bytes=64 << 20, hot_cache_min_df=1)
    assert len(ex._hot) > 0
    for q in QUERIES:
        got = ex.search(q, k=10)
        want = oracle_search(corpus, jax_parse(q).root, k=10)
        assert [r.doc_id for r in got] == [w[0] for w in want], q
        np.testing.assert_allclose([r.score for r in got],
                                   [w[1] for w in want], rtol=2.4e-7, atol=0)


def test_cached_with_deletions(seg_corpus, _restore_cfg):
    """Deletion masks compose with cached slots."""
    seg, _ = seg_corpus
    dead = np.random.default_rng(3).choice(seg.n_docs, size=200,
                                           replace=False)
    off = executor(seg, hot_cache_bytes=0)
    off.set_masked_local_docs(dead)
    on = executor(seg, hot_cache_bytes=64 << 20, hot_cache_min_df=1)
    on.set_masked_local_docs(dead)
    for q in QUERIES:
        assert _ids_scores(off.search(q, k=10)) == _ids_scores(
            on.search(q, k=10)), q


def test_budget_caps_cache(seg_corpus, _restore_cfg):
    """hot_cache_bytes bounds the plane count (highest df first)."""
    seg, _ = seg_corpus
    per = seg.n_windows * 128 * 128 * 4
    ex = executor(seg, hot_cache_bytes=3 * per, hot_cache_min_df=1)
    assert len(ex._hot) == 3
    top = np.argsort(-np.asarray(seg.term_df), kind="stable")[:3]
    assert set(ex._hot) == set(int(t) for t in top)
    assert ex.tf_planes.shape[0] == 3


def test_fuzz_cached_parity(seg_corpus, _restore_cfg):
    """Random boolean shapes: cache on == cache off exactly."""
    seg, _ = seg_corpus
    rng = np.random.default_rng(11)
    off = executor(seg, hot_cache_bytes=0)
    on = executor(seg, hot_cache_bytes=64 << 20, hot_cache_min_df=50)

    def rand_query(depth=0):
        r = rng.random()
        t = f"t{int(rng.integers(0, 60))}"
        if depth >= 2 or r < 0.4:
            return t
        op = rng.choice(["AND", "OR", "NOT"])
        return f"({rand_query(depth + 1)} {op} {rand_query(depth + 1)})"

    qs = [rand_query() for _ in range(24)]
    for a, b in zip(off.search_batch(qs, k=10), on.search_batch(qs, k=10)):
        assert _ids_scores(a) == _ids_scores(b)
