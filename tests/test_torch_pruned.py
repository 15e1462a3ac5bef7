"""The port's block-max pruned search against its dense path and the JAX package.

Twin of tests/test_pruned.py on the port's CPU executor: search_pruned and
search_pruned_batch equal search / search_batch exactly (flat, NOT and
general tape shapes, repeated queries, phrase and empty queries), tapes
that match a document holding none of their terms and phrase queries run
the dense batch with no ``pruned.rounds``, and on a skewed corpus the bound
skips windows (single query and batch). Beyond the twin:

- search_pruned_batch equals the JAX executor's (interpret mode, as the
  JAX package's own tests run it on the CPU): ids exactly, scores within
  2 ulp, with the same number of chunk rounds;
- a pruned chunk's cell tables (gathered ascending windows, the short
  last chunk padded with a duplicated window whose cells are zeroed, a
  resolved query's cells zeroed) decode through the plain version of the
  decode kernel bit-equal to the JAX kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trinity_tpu.ops.postings as ref_postings
from torch_twins import bulk_pair
from trinity_tpu.exec import Executor as JaxExecutor
from trinity_tpu.utils.metrics import get_metrics as ref_metrics
from trinity_tpu_torch import Executor, SegmentIndexSession
from trinity_tpu_torch.exec.pruned import chunk_cells, plan_pruned
from trinity_tpu_torch.exec.planning import _plan_for_text
from trinity_tpu_torch.ops import postings
from trinity_tpu_torch.utils.metrics import get_metrics

RTOL = 2.4e-7  # 2 ulp
VOCAB = 600


def _rounds(metrics=get_metrics):
    return metrics().snapshot().get("pruned.rounds", {}).get("value", 0)


def _pairs(res):
    return [(r.doc_id, r.score) for r in res]


@pytest.fixture(scope="module")
def segs():
    """A 3-window Zipf corpus (40,000 docs of 3-12 tokens) built by both
    packages' builders."""
    rng = np.random.default_rng(41)
    n_docs = 40_000
    zipf = 1.0 / np.arange(1, VOCAB + 1)
    zipf /= zipf.sum()
    bounds = np.zeros(n_docs + 1, np.int64)
    np.cumsum(rng.integers(3, 12, size=n_docs), out=bounds[1:])
    toks = rng.choice(VOCAB, size=int(bounds[-1]), p=zipf)
    seg, ref_seg = bulk_pair(np.arange(n_docs) + 3, toks, bounds,
                             [f"t{i}" for i in range(VOCAB)])
    assert seg.n_windows == 3
    return seg, ref_seg


@pytest.fixture(scope="module")
def big(segs):
    return Executor(segs[0], device="cpu")


@pytest.mark.parametrize(
    "qtext",
    ["t0", "t3 OR t9 OR t21", "t1 OR t500 OR t599", "t0 t1", "t5 t9 t13",
     "t599"],  # the last is rare
)
def test_pruned_exact(big, qtext):
    dense = big.search(qtext, k=10)
    pruned = big.search_pruned(qtext, k=10, chunk_windows=2)
    assert _pairs(pruned) == _pairs(dense), qtext


@pytest.mark.parametrize("qtext", ["t0 NOT t1", "t3 OR t9 NOT t21"])
def test_pruned_not_shape(big, qtext):
    """`flat NOT rhs` prunes with the lhs bound (the rhs only removes
    matches); results stay exact."""
    assert _pairs(big.search_pruned(qtext, k=10)) == _pairs(
        big.search(qtext, k=10)), qtext


@pytest.mark.parametrize("qtext", ["t0 OR <t1>", "<t1> OR t0"])
def test_pruned_matches_empty_routes_dense(big, qtext):
    """A tape matching a document that holds none of its terms runs the
    dense batch: no pruned chunk, exact results."""
    before = _rounds()
    pruned = big.search_pruned(qtext, k=10, chunk_windows=2)
    assert _rounds() == before, qtext
    assert _pairs(pruned) == _pairs(big.search(qtext, k=10)), qtext


def test_pruned_fallback_on_complex(big):
    q = '"t0 t1" OR t3'  # a phrase inside a tree: dense
    before = _rounds()
    pruned = big.search_pruned(q, k=10)
    assert _rounds() == before
    assert _pairs(pruned) == _pairs(big.search(q, k=10))


@pytest.mark.parametrize(
    "qtext",
    ["[t0,t3,t9]", "(t0 t1) OR (t5 t9)", "(t0 OR t3) t9", "t0 ([t1,t5] OR t13)",
     "(t3 OR t9) NOT (t0 t1)"],
)
def test_pruned_exact_general_shapes(big, qtext):
    """Any boolean tape prunes (k-of-n, OR-of-AND, nested) with exact
    results, alone and batched."""
    dense = big.search(qtext, k=10)
    assert _pairs(big.search_pruned(qtext, k=10, chunk_windows=2)) == _pairs(
        dense), qtext
    for rb in big.search_pruned_batch([qtext, qtext], k=10, chunk_windows=2):
        assert _pairs(rb) == _pairs(dense), qtext


BATCH = ["t0 t1", "t3 OR t9 OR t21", "t0 t1", "t5 t9 t13", "t0 NOT t1",
         '"t0 t1"', "[t0,t3,t9]", "(t0 t1) OR (t5 t9)", "t599", ""]


def test_pruned_batch_matches_batch(big):
    """Repeated queries, NOT, phrase, k-of-n, OR-of-AND and an empty
    query: search_pruned_batch equals search_batch exactly."""
    a = big.search_batch(BATCH, k=10)
    b = big.search_pruned_batch(BATCH, k=10, chunk_windows=2)
    for q, ra, rb in zip(BATCH, a, b):
        assert _pairs(ra) == _pairs(rb), q
    assert b[-1] == []


def test_pruned_batch_equals_jax(segs, big):
    """search_pruned_batch against the JAX executor's: ids exactly, scores
    within 2 ulp, and the same number of chunk rounds."""
    qs = BATCH[:5] + BATCH[6:9]
    before, ref_before = _rounds(), _rounds(ref_metrics)
    got = big.search_pruned_batch(qs, k=10, chunk_windows=2)
    want = JaxExecutor(segs[1]).search_pruned_batch(qs, k=10,
                                                    chunk_windows=2)
    assert _rounds() - before == _rounds(ref_metrics) - ref_before > 0
    for q, g, w in zip(qs, got, want):
        assert len(w) > 0, q
        assert [d for d, _ in _pairs(g)] == [d for d, _ in _pairs(w)], q
        np.testing.assert_allclose([r.score for r in g], [r.score for r in w],
                                   rtol=RTOL, atol=0, err_msg=q)


def test_pruned_chunk_decode_equals_jax(segs, big):
    """The last chunk of a flat group's window order with chunk_windows=2
    on 3 windows (one window, padded by a duplicate of itself with zeroed
    cells), the first query resolved: the plain decode of its cells equals
    the JAX kernel's in interpret mode, and the duplicate and the resolved
    query's cells decode to zeros."""
    seg = segs[0]
    plans = [_plan_for_text(q)[1] for q in ("t0 t1", "t2 t5", "t3 t4")]
    (g,), dense = plan_pruned(big, plans, "bm25")
    assert not dense and g.key == ("flat", 2) and g.B == 4
    resolved = np.array([True, False, False, True])
    selp, csel, nsel = chunk_cells(g, 2, 2, resolved)
    assert selp[0] == selp[1] == g.order[2]
    assert nsel[1].sum() == 0 and nsel[:, :2].sum() == 0 and nsel.sum() > 0
    bmeta, planes = postings.pack_block_meta(seg), postings.pad_planes(
        seg.planes)
    W, T = csel.shape
    want = ref_postings.materialize_freq_tiles(
        jnp.asarray(bmeta), jnp.asarray(planes), jnp.asarray(csel),
        jnp.asarray(nsel), jnp.asarray(selp), n_windows=W, n_terms=T,
        interpret=True,
    )
    got = postings.materialize_freq_tiles(
        torch.from_numpy(bmeta), torch.from_numpy(planes.view(np.int32)),
        torch.from_numpy(csel), torch.from_numpy(nsel),
        torch.from_numpy(selp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1].abs().sum() == 0 and got[:, :2].abs().sum() == 0
    assert got[0, 2:].sum() > 0


def _skewed(extra_hot=(), extra_cold=()):
    """60,000 docs (4 windows): docs 40,000-40,099 hold "hot" 8 times (and
    `extra_hot` 4 times), every 7th other doc holds each once."""
    sess = SegmentIndexSession()
    docs = []
    for d in range(60_000):
        if 40_000 <= d < 40_100:
            docs.append(["hot"] * 8 + [t for t in extra_hot for _ in range(4)]
                        + ["filler"])
        else:
            docs.append((["hot", *extra_cold, "filler"]) if d % 7 == 0
                        else ["filler"])
    sess.bulk_index(list(range(60_000)), docs)
    return Executor(sess.commit(), device="cpu")


@pytest.mark.parametrize("qtext,extra", [
    ("hot", ()), ("(hot warm) OR [hot,warm]", ("warm",))],
    ids=["flat", "general-shape"])
def test_pruned_skips_windows(qtext, extra):
    """On a skewed corpus the bound skips windows: fewer chunk rounds than
    windows, and exact."""
    ex = _skewed(extra, extra)
    before = _rounds()
    pruned = ex.search_pruned(qtext, k=10, chunk_windows=1)
    calls = _rounds() - before
    assert _pairs(pruned) == _pairs(ex.search(qtext, k=10))
    assert 0 < calls < ex.seg.n_windows, calls


def test_pruned_batch_stops_early():
    """The shared-order batch loop stops before exhausting the windows."""
    ex = _skewed(("warm",), ("warm",))
    qs = ["hot", "warm", "hot warm"]
    before = _rounds()
    pruned = ex.search_pruned_batch(qs, k=10, chunk_windows=1)
    calls = _rounds() - before
    for ra, rb in zip(ex.search_batch(qs, k=10), pruned):
        assert _pairs(ra) == _pairs(rb)
    assert 0 < calls < ex.seg.n_windows, calls
