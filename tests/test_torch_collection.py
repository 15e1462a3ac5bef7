"""The port's collections and merge against the JAX package and the oracle.

Twin of tests/test_lifecycle.py's collection and merge cases, on the
port's CPU executors: old generations masked by newer ones (scored with
the collection's statistics, against oracle_search), match_ids, the
erase-only generation, persist/load, a merged segment that searches like
the collection, the merge (monolithic and partitioned) bit-identical to
the JAX package's (payloads included; one source shares its arrays),
retention_plan; plus each source's masked registry and
a three-generation collection's search_batch equal to the JAX
collection's (ids exactly, scores within 2 ulp). Each collection is built
from the same documents by both packages' builders (held equal).
"""

import numpy as np
import pytest

from torch_twins import assert_same_segment, build_pair, docs_pair
from trinity_tpu.index.builder import SegmentIndexSession as RefSession
from trinity_tpu.index.merge import (
    MergeCandidatesCollection as RefMerge,
    Retention as RefRetention,
)
from trinity_tpu.index.source import IndexSourcesCollection as RefCollection
from trinity_tpu.oracle import OracleCorpus, oracle_search
from trinity_tpu.query.parser import parse_query
from trinity_tpu_torch import (
    IndexSourcesCollection,
    MergeCandidatesCollection,
    Retention,
    SegmentIndexSession,
)
from trinity_tpu_torch.index.format import term_positions

RTOL = 2.4e-7  # 2 ulp

GEN1 = {
    1: "apple iphone case",
    2: "samsung galaxy phone",
    3: "apple macbook pro",
    4: "old apple newton device",
}
GEN2_UPDATES = {4: "refurbished apple newton message pad"}
GEN2_NEW = {10: "apple vision pro headset"}
GEN2_ERASED = [2]


def _split(docs):
    return {d: t.split() for d, t in docs.items()}


def _gen2(sess):
    for d, toks in _split(GEN2_NEW).items():
        p = sess.begin(d)
        for pos, t in enumerate(toks, start=1):
            p.insert(t, pos)
        sess.insert(p)
    for d, toks in _split(GEN2_UPDATES).items():
        p = sess.begin(d)
        for pos, t in enumerate(toks, start=1):
            p.insert(t, pos)
        sess.update(p)
    for d in GEN2_ERASED:
        sess.erase(d)


def _segments():
    """[(port segment, reference segment, generation)] of the lifecycle
    collection."""
    g1 = docs_pair(_split(GEN1))
    g2 = build_pair(_gen2)
    return [(*g1, 100), (*g2, 200)]


def build_collection():
    c = IndexSourcesCollection(device="cpu")
    for seg, _, gen in _segments():
        c.add_segment(seg, generation=gen)
    return c.commit()


def expected_corpus():
    corpus = OracleCorpus()
    live = dict(GEN1)
    live.pop(2)  # erased
    live.update(GEN2_UPDATES)
    live.update(GEN2_NEW)
    for doc_id, text in live.items():
        corpus.add(doc_id, text.split())
    return corpus


def _pairs(res):
    return [(r.doc_id, r.score) for r in res]


def _assert_same(got, want, what):
    assert [d for d, _ in got] == [d for d, _ in want], what
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=RTOL, atol=0, err_msg=what)


@pytest.mark.parametrize(
    "qtext", ["apple", "apple pro", "galaxy", "newton", "apple OR samsung",
              '"apple newton"']
)
def test_collection_masks_old_generations(qtext):
    c = build_collection()
    q = parse_query(qtext)
    got = c.search(qtext, k=10)
    # the reference aggregates df / docs_cnt over raw segments, shadowed
    # copies included
    want = oracle_search(expected_corpus(), q.root, k=10,
                         docs_cnt=c.aggregated_stats().docs_cnt,
                         df_of=c.doc_freq)
    _assert_same(_pairs(got), want, qtext)


def test_collection_stats_ignore_masking():
    c = build_collection()
    assert c.aggregated_stats().docs_cnt == 4 + 2  # shadowed doc 4 counted
    assert c.doc_freq("apple") == 3 + 2 and c.doc_freq("galaxy") == 1


def test_collection_match_ids():
    c = build_collection()
    assert list(c.match_ids("apple")) == [1, 3, 4, 10]
    assert list(c.match_ids("galaxy")) == []  # doc 2 erased
    assert list(c.match_ids('"apple newton"')) == [4]  # the gen-2 copy


def test_mask_only_generation(tmp_path):
    """An erase-only commit is a 0-doc segment of updated ids: it masks
    older generations and is no search target, across persist/load."""
    c = IndexSourcesCollection(device="cpu")
    c.add_segment(docs_pair(_split(GEN1))[0], generation=100)
    erase_only = SegmentIndexSession()
    erase_only.erase(2)
    erase_only.erase(4)
    seg = erase_only.commit()
    assert seg.n_docs == 0 and list(seg.updated_ids) == [2, 4]
    c.add_segment(seg, generation=200)
    assert list(c.match_ids("apple")) == [1, 3]  # 4 masked
    assert list(c.match_ids("galaxy")) == []  # 2 masked
    empty = c.sources[0].executor()  # newest first after commit
    assert empty.seg.n_docs == 0 and empty._dev is None  # nothing uploaded
    c.persist(str(tmp_path))
    c2 = IndexSourcesCollection.load(str(tmp_path), device="cpu")
    assert c2.device == "cpu" and all(s.device == "cpu" for s in c2.sources)
    assert list(c2.match_ids("apple")) == [1, 3]
    assert _pairs(c2.search("apple", k=10)) == _pairs(c.search("apple", k=10))


def test_collection_persist_load(tmp_path):
    c = build_collection()
    c.persist(str(tmp_path))
    c2 = IndexSourcesCollection.load(str(tmp_path), device="cpu")
    assert _pairs(c2.search("apple", k=10)) == _pairs(c.search("apple", k=10))


def test_masked_registry_equals_jax():
    """Each port source masks the same local docs as the JAX source."""
    port, ref = IndexSourcesCollection(device="cpu"), RefCollection()
    for seg, ref_seg, gen in _segments():
        port.add_segment(seg, generation=gen)
        ref.add_segment(ref_seg, generation=gen)
    port.commit()
    ref.commit()
    for a, b in zip(port.sources, ref.sources):
        assert a.generation == b.generation
        ma, mb = a.executor()._deleted_np, b.executor()._deleted_np
        assert (ma is None) == (mb is None)
        if mb is not None:
            np.testing.assert_array_equal(ma, mb)
    assert port.sources[1].executor()._deleted_np.sum() == 2  # docs 2 and 4


def _mc_pair():
    port, ref = MergeCandidatesCollection(), RefMerge()
    for seg, ref_seg, gen in _segments():
        port.insert(seg, generation=gen)
        ref.insert(ref_seg, generation=gen)
    return port, ref


def test_merge_matches_collection():
    """The merged segment searches like the masked collection."""
    port, _ = _mc_pair()
    merged = port.merge(keep_updated_ids=False)
    corpus = expected_corpus()
    assert merged.n_docs == corpus.docs_cnt
    single = IndexSourcesCollection(device="cpu").add_segment(
        merged, generation=300).commit()
    for qtext in ["apple", "newton", "apple OR samsung", "pro -macbook"]:
        want = oracle_search(corpus, parse_query(qtext).root, k=10)
        assert [r.doc_id for r in single.search(qtext, k=10)] == [
            d for d, _ in want], qtext


def test_merge_positions_and_updated_ids():
    port, _ = _mc_pair()
    merged = port.merge()
    local = int(np.searchsorted(merged.doc_map, 4))
    assert list(term_positions(merged, merged.term_id("newton"), local)) == [3]
    np.testing.assert_array_equal(merged.updated_ids,
                                  np.array([2, 4], np.uint32))


@pytest.mark.parametrize("partitioned", [False, True])
@pytest.mark.parametrize("keep_updated_ids", [True, False])
def test_merge_equals_jax_merge(partitioned, keep_updated_ids):
    """The port's merge (and merge_partitioned, with term partitions of 4
    hits) gives the JAX package's merged segment, array by array."""
    port, ref = _mc_pair()
    kw = dict(keep_updated_ids=keep_updated_ids)
    if partitioned:
        got = port.merge_partitioned(budget_hits=4, **kw)
    else:
        got = port.merge(**kw)
    assert_same_segment(got, ref.merge(**kw))


def test_merge_partitioned_random_equals_jax():
    """A 3-way merge of interleaved docid spaces with repeated tokens
    (multi-block terms): port merge_partitioned == port merge == JAX
    merge."""
    rng = np.random.default_rng(11)
    port_a, port_b, ref = (MergeCandidatesCollection(),
                           MergeCandidatesCollection(), RefMerge())
    for g, stride in ((1, 0), (2, 1), (3, 2)):
        docs = {i: [f"w{int(x)}" for x in rng.integers(0, 40, 16)]
                for i in range(stride, 600, 3)}
        seg, ref_seg = docs_pair(docs)
        port_a.insert(seg, generation=g)
        port_b.insert(seg, generation=g)
        ref.insert(ref_seg, generation=g)
    want = ref.merge()
    assert_same_segment(port_a.merge(), want)
    assert_same_segment(port_b.merge_partitioned(budget_hits=257), want)


def test_retention_plan():
    port, ref = _mc_pair()
    port.commit()
    ref.commit()
    plan = port.retention_plan([200])
    assert plan == {200: Retention.DELETE, 100: Retention.RETAIN_ALL}
    assert {g: r.name for g, r in plan.items()} == {
        g: r.name for g, r in ref.retention_plan([200]).items()}
    assert RefRetention.DELETE.value == Retention.DELETE.value


def test_collection_pruned_matches_batch():
    c = build_collection()
    qs = ["apple", "apple pro", "apple OR galaxy"]
    want = c.search_batch(qs, k=10)
    got = c.search_pruned_batch(qs, k=10, chunk_windows=2)
    for q, a, b in zip(qs, got, want):
        assert _pairs(a) == _pairs(b), q


def _three_generations():
    """(port collection, JAX collection) of three generations built from
    one seed: 3,000 docs, then 800 (500 updates of old ids, 300 new ids),
    then an erase-only generation of 200 further old ids."""
    rng = np.random.default_rng(9)
    vocab = [f"t{i}" for i in range(60)]
    zipf = 1.0 / np.arange(1, 61)
    zipf /= zipf.sum()
    doc = lambda: list(rng.choice(vocab, size=int(rng.integers(3, 14)),
                                  p=zipf))
    old = {d: doc() for d in range(1, 3001)}
    upd = rng.choice(np.arange(1, 3001), 700, replace=False)
    new = {int(d): doc() for d in upd[:500]}
    new.update({d: doc() for d in range(5000, 5300)})

    def gen2(sess):
        for d, toks in new.items():
            p = sess.begin(d)
            for pos, t in enumerate(toks, start=1):
                p.insert(t, pos)
            sess.insert(p) if d >= 5000 else sess.update(p)

    def gen3(sess):
        for d in upd[500:]:
            sess.erase(int(d))

    pairs = [docs_pair(old), build_pair(gen2), build_pair(gen3)]
    port, ref = IndexSourcesCollection(device="cpu"), RefCollection()
    for gen, (seg, ref_seg) in enumerate(pairs, start=1):
        port.add_segment(seg, generation=gen)
        ref.add_segment(ref_seg, generation=gen)
    return port.commit(), ref.commit()


COLLECTION_QUERIES = ["t1 t2", "t3 OR t4", '"t1 t2"', "t5 NOT t6", "t0",
                      "(t0 t7) OR (t2 t9)", "[t1, t3, t8]/2", '"t0 t1" t4']


def test_collection_search_batch_equals_jax():
    port, ref = _three_generations()
    got = port.search_batch(COLLECTION_QUERIES, k=10)
    want = ref.search_batch(COLLECTION_QUERIES, k=10)
    for q, g, w in zip(COLLECTION_QUERIES, got, want):
        assert len(w) > 0, q
        _assert_same(_pairs(g), _pairs(w), q)
    for q in COLLECTION_QUERIES[:3]:
        np.testing.assert_array_equal(port.match_ids(q), ref.match_ids(q))
    pruned = port.search_pruned_batch(COLLECTION_QUERIES, k=10,
                                      chunk_windows=1)
    for q, g, p in zip(COLLECTION_QUERIES, got, pruned):
        assert _pairs(p) == _pairs(g), q


def test_update_shadows_older_copies():
    """A third generation updating ids of both older ones: no app id
    appears twice in a collection top-k."""
    port, _ = _three_generations()
    sess = SegmentIndexSession()
    for d in range(1, 200):
        p = sess.begin(d)
        for pos, t in enumerate(["zz", "t1"], start=1):
            p.insert(t, pos)
        sess.update(p)
    port.add_segment(sess.commit(), generation=4).commit()
    ids = [r.doc_id for r in port.search_batch(["t1 OR zz"], k=300)[0]]
    assert len(ids) == 300 and len(ids) == len(set(ids))


def _payload_pair(lo, hi, texts):
    """A segment with payloads (doc_id * 100 + position) from both
    builders."""
    def fill(sess):
        for d in range(lo, hi):
            p = sess.begin(d)
            for pos, t in enumerate(texts[d], start=1):
                p.insert(t, pos, payload=d * 100 + pos)
            sess.insert(p)

    segs = []
    for mod in (SegmentIndexSession, RefSession):
        sess = mod(track_payloads=True)
        fill(sess)
        segs.append(sess.commit())
    assert_same_segment(*segs)
    return segs


@pytest.mark.parametrize("partitioned", [False, True])
def test_merge_with_payloads_equals_jax(partitioned):
    """Payload streams survive the merge (monolithic and partitioned, with
    overlapping doc ranges), equal to the JAX package's merge."""
    rng = np.random.default_rng(5)
    texts = {d: [f"t{int(x)}" for x in rng.integers(0, 25, 10)]
             for d in range(220)}
    port, ref = MergeCandidatesCollection(), RefMerge()
    for g, (lo, hi) in ((1, (0, 120)), (2, (100, 220))):
        seg, ref_seg = _payload_pair(lo, hi, texts)
        port.insert(seg, generation=g)
        ref.insert(ref_seg, generation=g)
    got = (port.merge_partitioned(budget_hits=64) if partitioned
           else port.merge())
    assert got.payloads is not None and got.n_docs == 220
    assert_same_segment(got, ref.merge())


def test_merge_single_source_fast_path():
    """One candidate, nothing masked: the arrays are shared, not
    re-encoded (merge.cpp:166-180), as in the JAX merge."""
    seg, ref_seg = docs_pair({d: ["a", "b"] if d % 2 else ["a"]
                              for d in range(200)})
    port, ref = MergeCandidatesCollection(), RefMerge()
    port.insert(seg, generation=5)
    ref.insert(ref_seg, generation=5)
    merged = port.merge()
    assert merged.planes is seg.planes
    assert_same_segment(merged, ref.merge())
