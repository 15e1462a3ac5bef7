"""The port's boolean slice end to end against the JAX package and the oracle.

On a 3-window segment made from a numpy seed, with the hot-term plane
cache forced on (so every group mixes cached and decoded slots) and a
deletion registry installed, the port's search_batch and search equal

  - the JAX Executor's search_batch (interpret mode, as the JAX package's
    own tests run it on the CPU), for BM25, and
  - oracle_search, for BM25, TF-IDF and Trivial;

ids exactly, scores within 2 ulp (rtol=2.4e-7, atol=0). The mix covers
flat AND / OR / NOT / k-of-n / optional groups, an OR-of-AND (tape kernel)
group and one >8-slot query (dense path). state_from_numpy of the JAX
executor's device arrays equals the port's own state, and a pure phrase and
a phrase inside an AND, batched with a boolean query, equal the JAX
executor's results. The corpus is built by both packages' builders (held
equal); each executor gets its own package's segment, and the hot-term
cache is configured in both packages.
"""

import numpy as np
import pytest
import torch

from torch_twins import bulk_pair, reconfigured
from trinity_tpu.exec import Executor as JaxExecutor
from trinity_tpu.oracle import OracleCorpus, oracle_search
from trinity_tpu.query.parser import parse_query
from trinity_tpu_torch import Executor, state_from_numpy

RTOL = 2.4e-7  # 2 ulp

QUERIES = [
    "t0 t1",                      # flat AND, two cached terms
    "t3 t60",                     # cached + decoded
    "t2 OR t40 OR t150",          # flat OR
    "t1 NOT t0",                  # flat NOT
    "t4 t9 NOT t2",               # 2-positive NOT
    "[t5, t9, t31, t77]/2",       # k-of-n
    "t6 <t8>",                    # optional member
    "(t0 t9) OR (t3 t50)",        # OR-of-AND: tape kernel
    "(t1 t20) OR (t7 t90)",       # same shape, same group
    " OR ".join(f"t{i}" for i in range(20, 31)),  # 11 slots: dense path
]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(29)
    n_docs, vocab = 35_000, 250
    zipf = 1.0 / np.arange(1, vocab + 1) ** 1.05
    zipf /= zipf.sum()
    lens = rng.integers(3, 12, size=n_docs)
    bounds = np.zeros(n_docs + 1, np.int64)
    np.cumsum(lens, out=bounds[1:])
    toks = rng.choice(vocab, size=int(bounds[-1]), p=zipf)
    names = [f"t{i}" for i in range(vocab)]
    doc_ids = np.arange(n_docs) * 3 + 7
    seg, ref_seg = bulk_pair(doc_ids, toks, bounds, names)
    oc = OracleCorpus()
    for d in range(n_docs):
        oc.add(int(doc_ids[d]), [names[t] for t in toks[bounds[d]:bounds[d + 1]]])
    masked = np.arange(0, n_docs, 13)
    return (seg, ref_seg), oc, masked, {int(doc_ids[i]) for i in masked}


@pytest.fixture(scope="module")
def hot():
    with reconfigured(hot_cache_bytes=64 << 20, hot_cache_min_df=3000):
        yield


@pytest.fixture(scope="module")
def port(corpus, hot):
    (seg, _), _, masked, _ = corpus
    ex = Executor(seg, device="cpu")
    assert 0 < len(ex._hot) < seg.n_terms
    ex.set_masked_local_docs(masked)
    kinds = {g.kind for g in ex.plan_batch(QUERIES)}
    assert kinds == {"flat", "fused", "dense"}
    return ex


@pytest.fixture(scope="module")
def jax_run(corpus, hot):
    (_, ref_seg), _, masked, _ = corpus
    jx = JaxExecutor(ref_seg)
    jx.set_masked_local_docs(masked)
    return jx, jx.search_batch(QUERIES, k=10)


def _pairs(res):
    return [(r.doc_id, r.score) for r in res]


def _assert_same(got, want, what):
    assert [d for d, _ in got] == [d for d, _ in want], what
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=RTOL, atol=0, err_msg=what)


def test_search_batch_equals_jax_executor(port, jax_run):
    _, want = jax_run
    got = port.search_batch(QUERIES, k=10)
    for q, g, w in zip(QUERIES, got, want):
        assert len(w) > 0, q
        _assert_same(_pairs(g), _pairs(w), q)


@pytest.mark.parametrize("scorer", ["bm25", "tfidf", "trivial"])
def test_search_batch_equals_oracle(port, corpus, scorer):
    _, oc, _, masked_app = corpus
    got = port.search_batch(QUERIES, k=10, scorer=scorer)
    for q, g in zip(QUERIES, got):
        want = oracle_search(oc, parse_query(q).root, k=10, scorer=scorer,
                             masked=masked_app)
        _assert_same(_pairs(g), want, f"{scorer}: {q}")


def test_search_is_batch_of_one(port):
    batch = port.search_batch(QUERIES, k=5)
    for q, b in zip(QUERIES, batch):
        assert _pairs(port.search(q, k=5)) == _pairs(b), q


def test_state_from_numpy_equals_own_state(port, jax_run):
    jx, _ = jax_run
    st = state_from_numpy(
        {"bmeta": np.asarray(jx.bmeta), "planes": np.asarray(jx.planes),
         "tf_planes": np.asarray(jx.tf_planes),
         "deleted_tiles": np.asarray(jx._deleted_tiles)},
        "cpu",
    )
    own = {"bmeta": port.bmeta, "planes": port.planes,
           "tf_planes": port.tf_planes, "deleted_tiles": port._deleted_tiles}
    for name, t in own.items():
        assert st[name].dtype == t.dtype, name
        assert torch.equal(st[name], t), name


def test_phrase_raises(port, jax_run):
    """The two phrase calls run, on the posmask and compound paths, and
    equal the JAX executor. (The name is kept from when the port refused
    phrases, so the test keeps its history across runs.)"""
    jx, _ = jax_run
    _assert_same(_pairs(port.search('"t0 t1"')), _pairs(jx.search('"t0 t1"')),
                 '"t0 t1"')
    batch = ["t0 t1", '"t2 t3" t4']
    assert {g.kind for g in port.plan_batch(batch)} == {"flat", "phrase"}
    for q, g, w in zip(batch, port.search_batch(batch),
                       jx.search_batch(batch)):
        assert len(w) > 0, q
        _assert_same(_pairs(g), _pairs(w), q)
