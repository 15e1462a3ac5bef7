"""Twin of tests/test_mesh.py and __graft_entry__.py's dryrun_multichip:
the port's mesh (trinity_tpu_torch/parallel/mesh.py) on the CPU, four
shards on one device.

- ``split_segment`` equals the JAX package's, array by array, shard by
  shard, on one corpus built by both packages' builders;
- ``MeshExecutor(seg, devices="cpu", n_shards=4)`` equals the port's single
  ``Executor`` on the unsharded segment bit for bit: boolean (flat, tape,
  dense), phrases (posmask, lazy, compound), batched and one at a time,
  under masks, pruned, ``match_ids`` and ``exec_rich`` (its whole callback
  stream, with ``AbortSearch`` and ``filter_factory``);
- the dryrun_multichip sequence with its shard-sparse queries (``"p0
  p1"`` on the first shard only, ``s0`` on a band, ``"zq zr"`` nowhere);
- ``MeshSourcesCollection`` with an update generation and an erase-only
  one, against ``IndexSourcesCollection``;
- the 2^24 guard (twin of tests/test_limits_guard.py:57-65), warmup and
  the strict seal;
- one direct comparison with the JAX ``MeshExecutor`` (four shards, a
  mixed batch under a mask, a two-window segment).
"""

import dataclasses

import numpy as np
import pytest

from torch_twins import assert_same_segment, bulk_pair, reconfigured
from trinity_tpu.parallel import MeshExecutor as JaxMeshExecutor
from trinity_tpu.parallel import split_segment as jax_split
from trinity_tpu_torch import (
    AbortSearch,
    Executor,
    IndexSourcesCollection,
    SegmentIndexSession,
    exec_rich,
)
from trinity_tpu_torch.limits import MAX_SEGMENT_DOCS
from trinity_tpu_torch.parallel import (
    MeshExecutor,
    MeshSourcesCollection,
    split_segment,
)
from trinity_tpu_torch.utils.seal import (
    post_seal_misses,
    seal_programs,
    unseal_programs,
)

RTOL = 2.4e-7  # 2 ulp

BOOLEAN = ["t0 t1", "t5 OR t9 OR t17", "t3 NOT t2", "[t1, t2, t3]/2", "t59",
           "t0 t1 OR t5", "(t1 t2) OR (t3 t4)", "t0 <t2>",
           "t0 OR t1 OR t2 OR t3 OR t4 OR t5 OR t6 OR t7 OR t8 OR t9"]
PHRASES = ['"t0 t1"', '"t1 t2 t3"', '"t1 t2" OR t7', 't4 NOT "t0 t1"']
SPARSE = ['"p0 p1"', '"zq zr"', "s0 OR t3", '"t0 t1"']


def shard_sparse_pair(n_docs, vocab=60, seed=11):
    """dryrun_multichip's corpus, drawn in bulk: 3-11 tokens a document
    from `vocab` terms, "p0 p1" opening the first eighth of the documents
    (one shard of 8), "s0" ending a band of a sixteenth from the middle;
    app ids 3, 5, 7, ... Built by both packages: (port, reference)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 12, n_docs)
    bounds = np.zeros(n_docs + 1, np.int64)
    np.cumsum(lens, out=bounds[1:])
    toks = rng.integers(0, vocab, int(bounds[-1]))
    first = bounds[: n_docs // 8]
    toks[first], toks[first + 1] = vocab, vocab + 1  # p0 p1
    band = np.arange(n_docs // 2, n_docs // 2 + n_docs // 16)
    toks[bounds[band + 1] - 1] = vocab + 2  # s0
    names = [f"t{i}" for i in range(vocab)] + ["p0", "p1", "s0"]
    return bulk_pair(3 + 2 * np.arange(n_docs), toks, bounds, names)


@pytest.fixture(scope="module")
def pair40k():
    return shard_sparse_pair(40_000)


@pytest.fixture(scope="module")
def mesh(pair40k):
    seg = pair40k[0]
    return seg, Executor(seg, "cpu"), MeshExecutor(seg, "cpu", n_shards=4)


def same(got, want, exact=True):
    """Top-k lists equal: ids exactly, scores bit-equal (or within 2
    ulp)."""
    for g, w in zip(got, want, strict=True):
        assert [r.doc_id for r in g] == [r.doc_id for r in w]
        if exact:
            assert [r.score for r in g] == [r.score for r in w]
        else:
            np.testing.assert_allclose([r.score for r in g],
                                       [r.score for r in w], rtol=RTOL,
                                       atol=0)


def stream(run, query, **kw):
    """A rich-match callback stream: per match its doc id and each matched
    term's hit positions."""
    out = []
    n = run(query, lambda md: out.append((md.doc_id, [
        (t.term, [h.pos for h in t.hits]) for t in md.matched_terms])), **kw)
    assert n == len(out)
    return out


@pytest.mark.parametrize("n_shards", [3, 4])
def test_split_segment_equals_jax(pair40k, n_shards):
    port, ref = pair40k
    got, want = split_segment(port, n_shards), jax_split(ref, n_shards)
    assert len(got) == len(want) == n_shards
    for g, w in zip(got, want):
        assert_same_segment(g, w)
    assert sum(s.n_docs for s in got) == port.n_docs


def test_mesh_layout(mesh):
    seg, _, mex = mesh
    assert [s.n_docs for s in mex.shards] == [16384, 16384, 7232, 0]
    assert [d.type for d in mex.devices] == ["cpu"] * 4
    np.testing.assert_array_equal(mex.doc_map, seg.doc_map)
    for t in ("t0", "p0", "s0", "zq"):
        tid = seg.term_id(t)
        assert mex.doc_freq(t) == (int(seg.term_df[tid]) if tid >= 0 else 0)
    assert mex.docs_cnt == seg.stats.docs_cnt == seg.n_docs


@pytest.mark.parametrize("queries", [BOOLEAN, PHRASES],
                         ids=["boolean", "phrase"])
def test_mesh_equals_single_executor(mesh, queries):
    """Batched, one at a time, and through launch/finish: bit-equal to
    the single executor."""
    _, ex, mex = mesh
    want = ex.search_batch(queries, k=10)
    same(mex.search_batch(queries, k=10), want)
    same([mex.search(q, k=10) for q in queries], want)
    same([mex.finish(mex.launch(q, k=10)) for q in queries], want)
    assert sum(1 for w in want if w) >= 3
    kinds = {g.kind for g in ex.plan_batch(queries)}
    assert kinds <= {"flat", "fused", "dense", "posph", "phrase"}
    assert mex.launch("-negonly") is None


def test_mesh_lazy_phrases_equal_single_executor(pair40k):
    """With posmask off the pure phrases take the lazy route on every
    shard."""
    seg = pair40k[0]
    with reconfigured(use_posmask=False):
        ex = Executor(seg, "cpu")
        mex = MeshExecutor(seg, "cpu", n_shards=4)
        assert {g.kind for g in ex.plan_batch(PHRASES)} == {"lazyph",
                                                             "phrase"}
        same(mex.search_batch(PHRASES, k=10), ex.search_batch(PHRASES, k=10))


def test_mesh_under_masks_and_pruned(mesh):
    """Every 7th global docid masked: batch and pruned search equal the
    single executor under the same mask, and no masked id comes back."""
    seg, ex, mex = mesh
    masked = np.arange(0, seg.n_docs, 7)
    qs = BOOLEAN + PHRASES
    try:
        ex.set_masked_local_docs(masked)
        mex.set_masked_local_docs(masked)
        want = ex.search_batch(qs, k=10)
        same(mex.search_batch(qs, k=10), want)
        same(mex.search_pruned_batch(BOOLEAN, k=10, chunk_windows=1),
             want[: len(BOOLEAN)])
        dead = set(seg.doc_map[masked].tolist())
        assert not dead & {r.doc_id for g in want for r in g}
        np.testing.assert_array_equal(mex.match_ids("t0 t1"),
                                      ex.match_ids("t0 t1"))
    finally:
        ex.set_masked_local_docs(None)
        mex.set_masked_local_docs(None)
    same(mex.search_pruned_batch(BOOLEAN, k=10, chunk_windows=1),
         ex.search_batch(BOOLEAN, k=10))


def test_mesh_match_ids_and_exec_rich(mesh):
    _, ex, mex = mesh
    for q in ["t0 t1", "s0", '"p0 p1"', '"t1 t2" OR t7', "zq"]:
        np.testing.assert_array_equal(mex.match_ids(q), ex.match_ids(q))
        assert stream(mex.exec_rich, q) == stream(
            lambda *a, **kw: exec_rich(ex, *a, **kw), q)


def test_mesh_exec_rich_abort_and_filter_factory(mesh):
    """AbortSearch stops delivery at the single executor's prefix (ordered
    draining across shards); filter_factory is called once per shard and
    each shard's doc_filter applies."""
    seg, ex, mex = mesh
    want = [d for d, _ in stream(lambda *a, **kw: exec_rich(ex, *a, **kw),
                                 "t0 s0")]
    assert len(want) > 6
    first_shard = mex.shards[0].n_docs
    got = []

    def take(md):
        if len(got) >= 3:
            raise AbortSearch()
        got.append(md.doc_id)

    assert mex.exec_rich("t0 s0", take) == 3 and got == want[:3]
    # an abort past the first shard's matches, while later shards run
    cut = sum(d <= int(seg.doc_map[first_shard - 1]) for d in want) + 2
    got = []

    def take_cut(md):
        if len(got) >= cut:
            raise AbortSearch()
        got.append(md.doc_id)

    assert mex.exec_rich("t0 s0", take_cut) == cut and got == want[:cut]

    made = []

    def factory():
        made.append(1)
        return {"doc_filter": lambda d: d % 4 == 1}

    kept = [d for d, _ in stream(mex.exec_rich, "t0 s0",
                                 filter_factory=factory)]
    assert len(made) == len(mex.shards) == 4
    assert kept == [d for d in want if d % 4 != 1]


def test_dryrun_multichip_sequence(mesh):
    """__graft_entry__.py's dryrun_multichip on the port with four shards:
    search, masks, a launched phrase, batched == sequential == single,
    pruned, the shard-sparse batch, match_ids and exec_rich."""
    _, ex, mex = mesh
    q = "t0 t1 OR t5"
    single = ex.search(q, k=10)
    res = mex.search(q, k=10)
    assert res and [r.doc_id for r in res] == [r.doc_id for r in single]
    masked = np.arange(0, 1000, 3)
    try:
        mex.set_masked_local_docs(masked)
        ex.set_masked_local_docs(masked)
        same([mex.search(q, k=10)], [ex.search(q, k=10)])
        same([mex.finish(mex.launch('"t0 t1"', k=10))],
             [ex.search('"t0 t1"', k=10)])
        batch_q = ["t0 t1 OR t5", "t3 NOT t2", "t7 OR t9", '"t0 t1"',
                   "t0 t1 OR t5"]
        got_b = mex.search_batch(batch_q, k=10)
        same(got_b, [mex.search(x, k=10) for x in batch_q])
        same(got_b, ex.search_batch(batch_q, k=10))
    finally:
        mex.set_masked_local_docs(None)
        ex.set_masked_local_docs(None)
    same([mex.search_pruned(q, k=10, chunk_windows=2)], [single])
    got_s = mex.search_batch(SPARSE, k=10)
    same(got_s, ex.search_batch(SPARSE, k=10))
    assert got_s[0] and not got_s[1]
    # "p0 p1" lives on the first shard only, "s0" on the second
    assert {r.doc_id for r in got_s[0]} <= set(mex.shards[0].doc_map.tolist())
    df = lambda shard, t: (int(shard.term_df[shard.term_id(t)])
                           if shard.term_id(t) >= 0 else 0)
    assert df(mex.shards[0], "p0") and not df(mex.shards[1], "p0")
    assert df(mex.shards[1], "s0") and not df(mex.shards[0], "s0")
    for x in ["t0 t1", "s0", '"p0 p1"']:
        np.testing.assert_array_equal(mex.match_ids(x), ex.match_ids(x))
    assert stream(mex.exec_rich, '"p0 p1"') == stream(
        lambda *a, **kw: exec_rich(ex, *a, **kw), '"p0 p1"')


def _generations():
    """Generation 1: 20,000 documents (app ids 0..19,999); generation 2:
    updates of every 7th id below 3,000 and 500 new ids; generation 3:
    erases 300 further ids and holds no document."""
    rng = np.random.default_rng(77)

    def bulk(sess, ids):
        lens = rng.integers(3, 9, len(ids))
        bounds = np.zeros(len(ids) + 1, np.int64)
        np.cumsum(lens, out=bounds[1:])
        sess.bulk_index_ids(ids, rng.integers(0, 40, int(bounds[-1])),
                            bounds, [f"t{i}" for i in range(40)])

    s1 = SegmentIndexSession()
    bulk(s1, np.arange(20_000))
    s2 = SegmentIndexSession()
    upd = np.arange(0, 3000, 7)
    bulk(s2, np.concatenate([upd, 30_000 + np.arange(500)]))
    for d in upd:
        s2.erase(int(d))
    s3 = SegmentIndexSession()
    for d in range(5000, 5300):
        s3.erase(d)
    return s1.commit(), s2.commit(), s3.commit()


def test_mesh_sources_collection():
    """MeshSourcesCollection (four shards a source) against
    IndexSourcesCollection on the same three generations: search_batch,
    search, pruned, match_ids and exec_rich; the erase-only generation
    splits into four empty shards and still masks."""
    gens = _generations()
    flat = IndexSourcesCollection(device="cpu")
    meshc = MeshSourcesCollection(devices="cpu", n_shards=4)
    for g, seg in enumerate(gens, start=1):
        flat.add_segment(seg, g)
        meshc.add_segment(seg, g)
    flat.commit()
    meshc.commit()
    erase_only = meshc.sources[0].executor()
    assert [s.n_docs for s in erase_only.shards] == [0, 0, 0, 0]
    assert (sum(src.executor().docs_cnt for src in meshc.sources)
            == flat.aggregated_stats().docs_cnt)
    qs = ["t1 t2", "t5 OR t9", "t3 NOT t4", '"t1 t2"', "[t1, t2, t6]/2",
          "(t1 t2) OR t30"]
    want = flat.search_batch(qs, k=10)
    got = meshc.search_batch(qs, k=10)
    same(got, want, exact=False)
    same([meshc.search(q, k=10) for q in qs], got)
    same(meshc.search_pruned_batch(qs[:3], k=10, chunk_windows=1), got[:3])
    erased = set(range(5000, 5300)) | set(range(0, 3000, 7))
    for q in qs:
        ids = meshc.match_ids(q)
        np.testing.assert_array_equal(ids, flat.match_ids(q))
        assert not erased & set(ids.tolist()) - set(range(0, 3000, 7))
    assert stream(meshc.exec_rich, "t1 t2") == stream(flat.exec_rich, "t1 t2")


def test_mesh_rejects_2_24_total_docs():
    sess = SegmentIndexSession()
    p = sess.begin(1)
    p.insert("a", 1)
    sess.insert(p)
    half = dataclasses.replace(
        sess.commit(), doc_map=np.zeros(MAX_SEGMENT_DOCS // 2, np.uint32))
    with pytest.raises(ValueError, match="2\\^24"):
        MeshExecutor([half, dataclasses.replace(half)], devices="cpu")


def test_mesh_warmup_then_strict_seal(mesh):
    """warmup over the mix, then a strict seal: serving the same mix on
    the mesh records no new variant."""
    seg = mesh[0]
    mex = MeshExecutor(seg, "cpu", n_shards=4)
    qs = BOOLEAN + PHRASES
    w = mex.warmup(qs, k=10, threads=4)
    assert w["variants"] == len(qs) + 1 and w["programs"] > 0
    before = post_seal_misses()
    seal_programs(strict=True)
    try:
        mex.search_batch(qs, k=10)
        for q in qs:
            mex.search(q, k=10)
    finally:
        unseal_programs()
    assert post_seal_misses() == before


def test_default_devices_are_the_cards(mesh):
    """MeshExecutor(seg) takes every visible CUDA card: without one it
    raises rather than running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        MeshExecutor(mesh[0])
    with pytest.raises(RuntimeError, match="is_available"):
        MeshSourcesCollection().add_segment(mesh[0])


def test_mesh_equals_jax_mesh():
    """The port's mesh against the JAX MeshExecutor (four shards, two of
    them empty, on a two-window segment): a mixed batch under a mask."""
    port, ref = shard_sparse_pair(20_000, seed=5)
    pm = MeshExecutor(port, "cpu", n_shards=4)
    jm = JaxMeshExecutor(ref, n_shards=4)
    assert [s.n_docs for s in pm.shards] == [s.n_docs for s in jm.shards]
    masked = np.arange(0, port.n_docs, 5)
    pm.set_masked_local_docs(masked)
    jm.set_masked_local_docs(masked)
    qs = ["t0 t1 OR t5", "t3 NOT t2", "t7 OR t9", '"t0 t1"', '"p0 p1"',
          "s0 OR t3"]
    same(pm.search_batch(qs, k=10), jm.search_batch(qs, k=10), exact=False)
