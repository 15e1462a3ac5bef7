"""The port's phrase search against the JAX package and the oracle.

Device functions, on inputs made from a numpy seed, against the JAX
functions (exact: they are integer):
  - bound_select_candidates (ki, valid, tau, overflow), with and without
    overflow, with ties at the threshold, and the no-overflow shortcut;
    compact_mask on a width that is not a multiple of 128; gather_cols;
  - verify_phrases_device on a packed random positions stream, fcaps on
    every rung kind (single window, streamed member, streamed anchor),
    whole and in chunks.

Executor(seg, "cpu") phrase queries (pure phrases, repeated members,
phrases inside AND / OR / NOT / k-of-n trees) on test_posmask.py's
`phrased` corpus, with a deletion registry, equal
  - the JAX Executor's search_batch (interpret mode) on the posmask path,
    the lazy path (use_posmask=False) and the host-verify routes (no device
    position caps), and
  - oracle_search for BM25, TF-IDF and Trivial, on those routes, with the
    posmask hot cache holding every term, and with a candidate cap of 4
    that forces the lazy path's unresolved fallback;
ids exactly, scores within 2 ulp (rtol=2.4e-7, atol=0). Also: a segment
with no postings (erase-only), duplicate positions (posmask gated off),
max_position past the word budget, and a three-window segment. Every
corpus is built by both packages' builders (held equal); each executor
gets its own package's segment, and config knobs are set in both.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trinity_tpu.ops.select as ref_select
from torch_twins import build_pair, docs_pair, reconfigured
from trinity_tpu.exec import Executor as JaxExecutor
from trinity_tpu.exec.phrases import verify_phrases_device as jax_verify
from trinity_tpu.oracle import OracleCorpus, oracle_search
from trinity_tpu.query.parser import parse_query
from trinity_tpu.utils.bitpack import pack_value_groups
from trinity_tpu_torch import Executor
from trinity_tpu_torch.exec.phrases import verify_phrases_device
from trinity_tpu_torch.ops import select

RTOL = 2.4e-7  # 2 ulp

PHRASES = ['"t0 t1"', '"t1 t0"', '"t5 t6 t7"', '"t2 t2"', '"t28 t29"',
           '"t6 t7"', '"zq zr"']
COMPOUND = ['"t0 t1" OR t5', 't3 AND "t0 t2"', '"t0 t1" NOT t2',
            '"t0 t1" "t1 t2"', '[t7, "t0 t1"]', 't9 NOT "t5 t6"']
QUERIES = PHRASES + COMPOUND + ["t0 t1", "t3 OR t4"]


def build(docs):
    """{doc id: tokens} -> (port segment, reference segment, oracle
    corpus), positions from 1."""
    corpus = OracleCorpus()
    for d, toks in docs.items():
        corpus.add(d, toks)
    return (*docs_pair(docs), corpus)


@pytest.fixture(scope="module")
def phrased():
    rng = np.random.default_rng(91)
    zipf = 1.0 / np.arange(1, 31)
    zipf /= zipf.sum()
    docs = {}
    for d in range(1, 501):
        toks = [f"t{int(i)}" for i in rng.choice(30, size=int(rng.integers(6, 50)),
                                                  p=zipf)]
        r = rng.random()
        if r < 0.3:
            toks[2:4] = ["t0", "t1"]
        if 0.2 < r < 0.5:
            toks[0:3] = ["t5", "t6", "t7"]
        if r > 0.8:
            toks[1:3] = ["t2", "t2"]
        docs[d] = toks
    seg, ref_seg, corpus = build(docs)
    assert seg.positions_distinct
    masked = {d for d in docs if d % 7 == 0}
    local = np.flatnonzero(np.isin(seg.doc_map, sorted(masked)))
    return (seg, ref_seg), corpus, masked, local


def same(got, want, what):
    assert [d for d, _ in got] == [d for d, _ in want], what
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=RTOL, atol=0, err_msg=what)


def pairs(res):
    return [(r.doc_id, r.score) for r in res]


# ------------------------------------------------------------ selection
def assert_selection_equal(got, want):
    """(ki, valid, ...) equal; ki only where valid (the contract says
    nothing of the ids in invalid slots)."""
    valid = np.asarray(want[1])
    np.testing.assert_array_equal(got[1].numpy(), valid, err_msg="valid")
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy()[valid],
                                  np.asarray(want[0])[valid], err_msg="ki")
    for g, w, name in zip(got[2:], want[2:], ("tau", "overflow")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("C2, vmax, noov", [
    (40, 3, False),  # overflow, ties at tau
    (300, 5, False),  # no overflow on some rows
    (64, 1, False),  # binary bounds: tau = 1 with a docid-first quota
    (400, 5, True),  # shortcut, C2 above every row's count
])
def test_bound_select_equals_jax(C2, vmax, noov):
    rng = np.random.default_rng(C2 + vmax)
    B, N = 3, 1000  # N not a multiple of 128
    bound = rng.integers(0, vmax + 1, size=(B, N)).astype(np.int32)
    bound[:, rng.random(N) < 0.6] = 0
    bound[2, :] = 0  # an empty row
    want = ref_select.bound_select_candidates(jnp.asarray(bound), C2, vmax,
                                              assume_no_overflow=noov)
    got = select.bound_select_candidates(torch.from_numpy(bound), C2, vmax,
                                         assume_no_overflow=noov)
    assert_selection_equal(got, want)
    if not noov and C2 < 100:
        assert np.asarray(want[3])[:2].all()


def test_compact_and_gather_equal_jax():
    rng = np.random.default_rng(4)
    kept = rng.random((2, 700)) < 0.1
    for C2 in (8, 50, 200):
        want = ref_select.compact_mask(jnp.asarray(kept), C2)
        got = select.compact_mask(torch.from_numpy(kept), C2)
        assert_selection_equal(got, want)
    arr = rng.integers(0, 99, size=(2, 768)).astype(np.int32)
    ki = rng.integers(0, 768, size=(2, 40)).astype(np.int32)
    np.testing.assert_array_equal(
        select.gather_cols(torch.from_numpy(arr), torch.from_numpy(ki)).numpy(),
        np.asarray(ref_select.gather_cols(jnp.asarray(arr), jnp.asarray(ki))),
    )


# -------------------------------------------------------------- verify
def _stream(seed, H):
    rng = np.random.default_rng(seed)
    # a narrow position range, so random runs do hold adjacent positions
    positions = rng.integers(0, 40, H).astype(np.uint16)
    pw, off = pack_value_groups(positions)
    hit_pw = np.vstack([pw.reshape(-1, 128), np.zeros((1, 128), np.uint32)])
    return rng, hit_pw, off.astype(np.int32)


@pytest.mark.parametrize("fcaps, maxf", [
    ((8, 64, 8), (8, 64, 8)),
    ((512, 8), (500, 8)),
    ((8, 4096), (8, 1800)),  # streamed member
    ((4096, 8), (1800, 8)),  # streamed anchor
    ((64, 4096, 4096), (64, 700, 1300)),
])
def test_verify_phrases_device_equals_jax(fcaps, maxf):
    rng, hit_pw, hit_off = _stream(sum(maxf), 9000)
    n = 150
    freqs = np.stack([rng.integers(1, mf + 1, n) for mf in maxf],
                     axis=1).astype(np.int32)
    offs = np.stack([rng.integers(0, 9000 - mf, n) for mf in maxf],
                    axis=1).astype(np.int32)
    valid = rng.random(n) < 0.85
    want = np.asarray(jax_verify(
        jnp.asarray(hit_pw), jnp.asarray(hit_off), jnp.asarray(valid),
        jnp.asarray(freqs), jnp.asarray(offs), fcaps))
    args = (torch.from_numpy(hit_pw.view(np.int32)), torch.from_numpy(hit_off),
            torch.from_numpy(valid), torch.from_numpy(freqs),
            torch.from_numpy(offs), fcaps)
    got = verify_phrases_device(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # chunks of 128 candidates
    np.testing.assert_array_equal(verify_phrases_device(*args,
                                                        vol_budget=1).numpy(),
                                  want)
    assert want.any()


def test_verify_counts_planted_adjacency():
    """member0 at [1, 5, 9], member1 at [2, 6]: starts 1 and 5 verify."""
    pw, off = pack_value_groups(np.array([1, 5, 9, 2, 6, 3, 7, 30], np.uint16))
    hit_pw = torch.from_numpy(
        np.vstack([pw.reshape(-1, 128), np.zeros((1, 128), np.uint32)])
        .view(np.int32))
    out = verify_phrases_device(
        hit_pw, torch.from_numpy(off.astype(np.int32)),
        torch.tensor([True, False]), torch.tensor([[3, 2], [3, 2]]),
        torch.tensor([[0, 3], [0, 3]]), (8, 8))
    assert out.tolist() == [2, 0]


# ------------------------------------------------------- the executor
MODES = ["posmask", "lazy", "host"]


@contextlib.contextmanager
def mode(name):
    with reconfigured(use_posmask=name == "posmask"):
        yield


def no_caps(ex):
    ex._phrase_fcaps = lambda *a: None
    return ex


def port_executor(seg, local, name):
    ex = Executor(seg, "cpu")
    ex.set_masked_local_docs(local)
    return no_caps(ex) if name == "host" else ex


@pytest.mark.parametrize("name", MODES)
def test_phrases_equal_jax_executor(phrased, name):
    (seg, ref_seg), _, _, local = phrased
    with mode(name):
        jx = JaxExecutor(ref_seg)
        jx.set_masked_local_docs(local)
        if name == "host":
            no_caps(jx)
        want = jx.search_batch(QUERIES, k=10)
        ex = port_executor(seg, local, name)
        kinds = {g.kind for g in ex.plan_batch(QUERIES)}
        got = ex.search_batch(QUERIES, k=10)
    assert kinds == {"posmask": {"posph", "phrase", "flat"},
                     "lazy": {"lazyph", "phrase", "flat"},
                     "host": {"lazyhost", "phrase", "flat"}}[name]
    for q, g, w in zip(QUERIES, got, want):
        same(pairs(g), pairs(w), f"{name}: {q}")
    assert sum(1 for w in want if w) >= len(QUERIES) - 3


@pytest.mark.parametrize("scorer", ["bm25", "tfidf", "trivial"])
@pytest.mark.parametrize("name", MODES)
def test_phrases_equal_oracle(phrased, name, scorer):
    (seg, _), corpus, masked, local = phrased
    with mode(name):
        got = port_executor(seg, local, name).search_batch(QUERIES, k=10,
                                                           scorer=scorer)
    for q, g in zip(QUERIES, got):
        want = oracle_search(corpus, parse_query(q).root, k=10,
                             scorer=scorer, masked=masked)
        same(pairs(g), want, f"{name}/{scorer}: {q}")


def test_posmask_hot_cache_holds_every_term(phrased):
    (seg, _), corpus, masked, local = phrased
    with reconfigured(posmask_min_df=1, posmask_cache_bytes=1 << 30):
        ex = Executor(seg, "cpu")
        ex.set_masked_local_docs(local)
        assert len(ex._pos_hot) == seg.n_terms
        groups = [g for g in ex.plan_batch(PHRASES) if g.kind == "posph"]
        # every segment term cached: the kernel gets only the unknown
        # terms' columns ("zq zr"), which hold no block
        assert groups and all(not g.arrays["cn"].any() for g in groups)
        assert all(g.arrays["cn"].shape[1] == int((g.ctx["cidx"] < 0).sum())
                   for g in groups)
        got = ex.search_batch(PHRASES, k=10)
        assert ex.pos_planes.shape[1] == seg.n_terms
    for q, g in zip(PHRASES, got):
        same(pairs(g), oracle_search(corpus, parse_query(q).root, k=10,
                                     masked=masked), q)


def test_posmask_group_mixes_cache_and_kernel(phrased):
    """A cache for the 10 highest-df terms: a group reads cached members
    from the cache and only the uncached ones from the kernel's output."""
    (seg, _), corpus, masked, local = phrased
    per_term = seg.n_windows * (-(-(seg.max_position + 1) // 32)) * 128 * 128 * 4
    with reconfigured(posmask_min_df=1, posmask_cache_bytes=10 * per_term):
        ex = Executor(seg, "cpu")
        ex.set_masked_local_docs(local)
        assert len(ex._pos_hot) == 10
        groups = [g for g in ex.plan_batch(PHRASES) if g.kind == "posph"]
        mixed = [g for g in groups
                 if (g.ctx["cidx"] >= 0).any() and (g.ctx["cidx"] < 0).any()]
        assert mixed
        for g in groups:
            assert g.arrays["cn"].shape[1] == int((g.ctx["cidx"] < 0).sum())
        got = ex.search_batch(PHRASES, k=10)
    for q, g in zip(PHRASES, got):
        same(pairs(g), oracle_search(corpus, parse_query(q).root, k=10,
                                     masked=masked), q)


def test_lazy_overflow_falls_back_exactly(phrased):
    (seg, _), corpus, _, _ = phrased
    with reconfigured(use_posmask=False, phrase_lazy_candidates=4,
                      phrase_lazy_max_candidates=4):
        ex = Executor(seg, "cpu")
        handle = ex.launch_batch(PHRASES, k=10)
        flags = torch.cat([o[2] for o in handle[1] if o[2] is not None])
        assert not flags.all()  # some queries need the fallback
        got = ex.finish_batch(handle)
    for q, g in zip(PHRASES, got):
        same(pairs(g), oracle_search(corpus, parse_query(q).root, k=10), q)


def test_search_is_batch_of_one(phrased):
    (seg, _), _, _, local = phrased
    ex = port_executor(seg, local, "posmask")
    batch = ex.search_batch(QUERIES, k=5)
    for q, b in zip(QUERIES, batch):
        assert pairs(ex.search(q, k=5)) == pairs(b), q


def test_empty_segment():
    """A segment with no postings blocks (erase-only): phrases and
    boolean queries return nothing, on every route."""
    def fill(sess):
        sess.erase(7)
        sess.erase(9)

    seg, _ = build_pair(fill)
    assert len(seg.block_hits_off) == 0 and seg.n_docs == 0
    for name in MODES:
        with mode(name):
            ex = port_executor(seg, [], name)
            for q in ['"t0 t1"', '"t0 t1 t2"', '"t0 t1" OR t2', "t0 t1"]:
                assert ex.search(q, k=10) == [], (name, q)


def test_duplicate_positions_gate_posmask_off():
    """A doc inserting the same (term, position) twice: popcount would
    lose the anchored multiplicity, so the posmask path is gated off."""
    def fill(sess):
        for d, toks in ((1, ["a", "b", "c"]), (2, ["b", "a", "b"])):
            p = sess.begin(d)
            for pos, t in enumerate(toks, start=1):
                p.insert(t, pos)
            if d == 1:
                p.insert("a", 1)
            sess.insert(p)

    seg, ref_seg = build_pair(fill)
    assert not seg.positions_distinct
    ex = Executor(seg, "cpu")
    assert not ex._posmask_enabled
    got = ex.search('"a b"', k=10, scorer="trivial")
    want = JaxExecutor(ref_seg).search('"a b"', k=10, scorer="trivial")
    assert pairs(got) == pairs(want)
    assert [r.doc_id for r in got] == [1, 2] and got[0].score == 2.0


def test_max_position_gates_posmask():
    seg, _, corpus = build({1: ["a", "b"] + ["x"] * 200 + ["a", "b"],
                            2: ["b", "a"], 3: ["a", "b", "c"]})
    assert seg.positions_distinct
    ex = Executor(seg, "cpu")
    assert not ex._posmask_enabled  # positions up to 204 > 32 * 4
    got = ex.search('"a b"', k=5, scorer="trivial")
    same(pairs(got), oracle_search(corpus, parse_query('"a b"').root, k=5,
                                   scorer="trivial"), '"a b"')
    with reconfigured(posmask_max_words=8):
        ex = Executor(seg, "cpu")
        assert ex._posmask_enabled and ex._pw_words == 7
        assert pairs(ex.search('"a b"', k=5, scorer="trivial")) == pairs(got)


def test_multiwindow_phrases():
    """Two windows: boundary blocks lie in both windows' cells, and a
    posting outside a window must not land in its tile."""
    rng = np.random.default_rng(17)
    docs = {}
    for d in range(1, 17001):
        toks = [f"t{int(i)}" for i in rng.integers(0, 6, size=4)]
        if d % 5 == 0:
            toks[1:3] = ["t0", "t1"]
        docs[d] = toks
    seg, _, corpus = build(docs)
    assert seg.n_windows == 2
    qs = ['"t0 t1"', '"t1 t2"', 't3 "t0 t1"']
    for name in MODES:
        with mode(name):
            got = port_executor(seg, [], name).search_batch(qs, k=10)
        for q, g in zip(qs, got):
            same(pairs(g), oracle_search(corpus, parse_query(q).root, k=10),
                 f"{name}: {q}")
