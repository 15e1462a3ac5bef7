"""Twin of tests/test_baseline_configs.py: every BASELINE.json
configuration end to end through the port (its CPU executor, percolator
and mesh), against the oracle (trinity_tpu/oracle.py).

1. single-segment AND conjunction, BM25 top-10
2. OR/disjunction with skip-based (block-max) top-k pruning
3. phrase + proximity (positions decode, hit tracking)
4. percolator vs thousands of registered queries
5. multi-segment with merge + deletion masks, sharded over a mesh
"""

import numpy as np
import pytest

import trinity_tpu_torch as T
from test_torch_exec_e2e import make_corpus
from trinity_tpu.oracle import OracleCorpus, oracle_match_ids, oracle_search
from trinity_tpu.query.parser import parse_query as jax_parse
from trinity_tpu_torch.parallel import MeshExecutor, MeshSourcesCollection

RTOL = 2.4e-7  # 2 ulp


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(77)
    seg, corpus = make_corpus(
        rng, n_docs=30_000, vocab=500, doc_len_rng=(4, 16), id_stride=1
    )
    return T.Executor(seg, "cpu"), seg, corpus


def _check(got, corpus, qtext, **kw):
    want = oracle_search(corpus, jax_parse(qtext).root, k=10, **kw)
    assert [r.doc_id for r in got] == [d for d, _ in want], qtext
    np.testing.assert_allclose(
        [r.score for r in got], [s for _, s in want], rtol=RTOL, atol=0
    )


def test_config1_and_conjunction(setup):
    ex, seg, corpus = setup
    _check(ex.search("t0 t3 t7", k=10), corpus, "t0 t3 t7")


def test_config2_pruned_disjunction(setup):
    ex, seg, corpus = setup
    got = ex.search_pruned("t1 OR t9 OR t40", k=10, chunk_windows=1)
    _check(got, corpus, "t1 OR t9 OR t40")


def test_config3_phrase_proximity(setup):
    ex, seg, corpus = setup
    _check(ex.search('"t0 t1"', k=10), corpus, '"t0 t1"')
    # proximity metadata surfaces through rich-match (DocWordsSpace)
    seen = []
    T.exec_rich(ex, '"t0 t1"', seen.append)
    assert seen
    assert all(
        any(
            m.dws.test_phrase(["t0", "t1"], h.pos)
            for h in m.term("t0").hits
        )
        for m in seen
    )
    assert [m.doc_id for m in seen] == oracle_match_ids(
        corpus, jax_parse('"t0 t1"').root)


def test_config4_percolator_thousands(setup):
    rng = np.random.default_rng(5)
    p = T.Percolator(device="cpu")
    texts = []
    for i in range(3000):
        a, b = rng.integers(0, 400, 2)
        texts.append(f"t{a} t{b}" if i % 2 else f"t{a} OR t{b}")
        p.register(texts[-1])
    docs = [[f"t{int(x)}" for x in rng.integers(0, 400, 10)]
            for _ in range(32)]
    m = p.match_batch(docs)
    assert m.shape == (32, 3000)
    assert m.any()
    corpus = OracleCorpus()
    for i, toks in enumerate(docs):
        corpus.add(i, toks)
    for qi in range(0, 3000, 97):
        assert list(np.flatnonzero(m[:, qi])) == oracle_match_ids(
            corpus, jax_parse(texts[qi]).root), texts[qi]


def test_config5_multisegment_masks_mesh(setup):
    ex, seg, corpus = setup
    # generation 2 updates a doc and erases another; collection masks them
    sess = T.SegmentIndexSession()
    pr = sess.begin(3)  # doc 3 exists in gen 1 (id_stride=1, base 3)
    for i, tok in enumerate(["t0", "t3", "t7"], 1):
        pr.insert(tok, i)
    sess.update(pr)
    sess.erase(5)
    gen2 = sess.commit()
    coll = (
        T.IndexSourcesCollection(device="cpu")
        .add_segment(seg, generation=1)
        .add_segment(gen2, generation=2)
        .commit()
    )
    assert 3 in list(coll.match_ids("t0 t3 t7"))
    assert 5 not in list(coll.match_ids("t0 OR t1 OR t2 OR t3 OR t4"))
    # merge the collection -> one segment, equal results
    mc = T.MergeCandidatesCollection()
    for src in coll.sources:
        mc.add_source(src)
    merged = mc.merge(keep_updated_ids=False)
    single = T.IndexSourcesCollection(device="cpu").add_segment(merged)
    a = [(r.doc_id, r.score) for r in single.commit().search("t0 t3 t7",
                                                             k=10)]
    # mesh-shard the merged segment over 8 shards on the one device
    mex = MeshExecutor(merged, devices="cpu", n_shards=8)
    b = [(r.doc_id, r.score) for r in mex.search("t0 t3 t7", k=10)]
    assert a == b
    # the oracle over the collection's live documents
    live = OracleCorpus(docs=dict(corpus.docs))
    live.erase(5)
    live.add(3, ["t0", "t3", "t7"])
    _check(mex.search("t0 t3 t7", k=10), live, "t0 t3 t7")
    # the generations themselves, sharded (masks split per shard)
    meshc = (MeshSourcesCollection(devices="cpu", n_shards=8)
             .add_segment(seg, 1).add_segment(gen2, 2).commit())
    got = meshc.search_batch(["t0 t3 t7", "t1 OR t9"], k=10)
    want = coll.search_batch(["t0 t3 t7", "t1 OR t9"], k=10)
    for g, w in zip(got, want):
        assert [r.doc_id for r in g] == [r.doc_id for r in w]
        np.testing.assert_allclose([r.score for r in g],
                                   [r.score for r in w], rtol=RTOL, atol=0)
    assert 5 not in list(meshc.match_ids("t0 OR t1 OR t2 OR t3 OR t4"))
