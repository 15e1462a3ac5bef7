"""Twin of tests/test_percolator.py: the port's percolator
(trinity_tpu_torch/percolator.py) on the CPU, against the JAX package's
Percolator on the same registrations and documents (matrices equal) and
against the oracle, as the original is.

Added: ``eval_programs`` against the JAX ``_eval_programs`` on random
programs with k-of-n and deep nesting; the port's chunked evaluation (13
queries a chunk) equal to its unchunked one; a ``register`` between two
``match_stream`` batches (each yielded matrix equals ``match_batch`` of its
own epoch); and the twin of tests/test_limits_guard.py's 21-bit position
field case.
"""

import numpy as np
import pytest

from test_percolator import DOCS, QUERIES
from trinity_tpu import percolator as jax_percolator
from trinity_tpu.oracle import OracleCorpus, oracle_match_ids
from trinity_tpu.percolator import Percolator as JaxPercolator
from trinity_tpu.query.parser import parse_query
from trinity_tpu_torch import percolator as port_percolator
from trinity_tpu_torch.percolator import Percolator, eval_programs


def pair(texts):
    """(port percolator on the CPU, JAX percolator), each with `texts`
    registered in order."""
    p, j = Percolator(device="cpu"), JaxPercolator()
    for t in texts:
        assert p.register(t) == j.register(t)
    return p, j


def match_both(p, j, docs, first_pos=1):
    """The port's match_batch, held equal to the JAX package's."""
    got = p.match_batch(docs, first_pos)
    want = j.match_batch(docs, first_pos)
    assert got.dtype == bool and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def oracle_expected(qtext, docs):
    corpus = OracleCorpus()
    for i, toks in enumerate(docs):
        corpus.add(i, toks)
    return oracle_match_ids(corpus, parse_query(qtext).root)


@pytest.fixture(scope="module")
def setup():
    return pair(QUERIES)


def test_batch_match_parity(setup):
    p, j = setup
    docs = [d.split() for d in DOCS]
    m = match_both(p, j, docs)
    assert m.shape == (len(DOCS), len(QUERIES))
    for qi, qtext in enumerate(QUERIES):
        got = list(np.flatnonzero(m[:, qi]))
        want = oracle_expected(qtext, docs)
        assert got == want, f"query {qtext!r}: got {got} want {want}"


def test_single_match(setup):
    p, j = setup
    hits = p.match("apple iphone case".split())
    assert hits == j.match("apple iphone case".split())
    assert QUERIES.index("apple") in hits
    assert QUERIES.index("apple iphone") in hits
    assert QUERIES.index("apple NOT iphone") not in hits


def test_incremental_register():
    p, j = pair([])
    q1 = p.register("foo bar")
    j.register("foo bar")
    assert p.match(["foo", "bar"]) == [q1] == j.match(["foo", "bar"])
    q2 = p.register("foo NOT bar")
    j.register("foo NOT bar")
    assert p.match(["foo"]) == [q2] == j.match(["foo"])
    assert p.match(["foo", "bar"]) == [q1]


def test_null_query_never_matches():
    p, j = pair(["-onlynegative"])
    assert p.match(["onlynegative", "x"]) == [] == j.match(
        ["onlynegative", "x"])
    assert p.n_queries == 1


def test_phrase_adjacency():
    p, j = pair(['"new york"'])
    assert p.match("i love new york".split()) == [0]
    assert p.match("york new haven".split()) == []
    match_both(p, j, ["i love new york".split(), "york new haven".split()])


def _mixed_texts(rng, n, vocab):
    texts = []
    for i in range(n):
        a, b, c = rng.choice(vocab, 3, replace=False)
        texts.append([f"w{a} w{b}", f"w{a} OR w{b}", f"w{a} NOT w{b}",
                      f"[w{a}, w{b}, w{c}]"][i % 4])
    return texts


def test_many_queries_scale():
    """Thousands of registered queries, one evaluation; the first 20 and
    two later queries against the oracle, all against the JAX package."""
    rng = np.random.default_rng(0)
    texts = _mixed_texts(rng, 2000, 50)
    p, j = pair(texts)
    docs = [[f"w{int(x)}" for x in rng.choice(50, 8, replace=False)]
            for _ in range(64)]
    m = match_both(p, j, docs)
    assert m.shape == (64, 2000)
    for qi in list(range(20)) + [1999, 1000]:
        assert list(np.flatnonzero(m[:, qi])) == oracle_expected(
            texts[qi], docs), texts[qi]


def test_percolator_scale_with_phrases():
    """BASELINE config #4: 3,000 registered queries, a quarter phrases,
    against 1,000 documents; equal to the JAX package's matrix, and 30
    (doc, query) pairs against the oracle."""
    rng = np.random.default_rng(55)
    texts = []
    for i in range(3000):
        a, b, c = (int(x) for x in rng.integers(0, 200, 3))
        texts.append([f"v{a} v{b}", f"v{a} OR v{b} OR v{c}", f'"v{a} v{b}"',
                      f"v{a} NOT v{b}"][i % 4])
    p, j = pair(texts)
    docs = [[f"v{int(x)}" for x in rng.integers(0, 200, 30)]
            for _ in range(1000)]
    m = match_both(p, j, docs)
    assert m.shape == (1000, 3000)
    for di in rng.integers(0, 1000, 5):
        for qi in rng.integers(0, 3000, 6):
            want = oracle_expected(texts[int(qi)], [docs[int(di)]])
            assert bool(m[int(di), int(qi)]) == bool(want), (di, qi)


def _nested(rng, depth):
    """A random query text: terms, bigrams, AND / OR / NOT / optional and
    k-of-n groups nested up to `depth` levels."""
    if depth == 0 or rng.random() < 0.2:
        a, b = (int(x) for x in rng.integers(0, 12, 2))
        return f'"u{a} u{b}"' if rng.random() < 0.15 else f"u{a}"
    kids = [_nested(rng, depth - 1) for _ in range(int(rng.integers(2, 5)))]
    kind = int(rng.integers(0, 5))
    if kind == 0:
        return "(" + " ".join(kids) + ")"
    if kind == 1:
        return "(" + " OR ".join(kids) + ")"
    if kind == 2:
        return f"({kids[0]} NOT {kids[1]})"
    if kind == 3:
        return f"({kids[0]} <{kids[1]}>)"
    k = int(rng.integers(1, len(kids) + 1))
    return "[" + ", ".join(kids) + f"]/{k}"


def test_eval_programs_equals_jax_on_nested_programs():
    """Random deep programs with k-of-n (ADD / GE), NOT, optional and
    phrases: the port's eval_programs equals the JAX _eval_programs on one
    packed program set and random incidence matrices."""
    rng = np.random.default_rng(12)
    texts = [_nested(rng, 4) for _ in range(300)]
    p, j = pair(texts)
    ops, uniq = j._pack()
    np.testing.assert_array_equal(p._pack()[0], ops)
    assert p._pack()[1] == uniq
    codes = set(np.unique(ops[..., 0]).tolist())
    assert {port_percolator.OP_ADD, port_percolator.OP_GE,
            port_percolator.OP_ANDNOT, port_percolator.OP_OPT,
            port_percolator.OP_PUSH_PHRASE} <= codes
    assert port_percolator._static_stack_depth(ops) >= 4
    n_terms = max(1, len(j._vocab))
    for density in (0.1, 0.5):
        inc = rng.random((40, n_terms)) < density
        ph = rng.random((40, max(1, len(uniq)))) < density
        want = jax_percolator._eval_programs(ops, inc, ph)
        got = eval_programs(ops, inc, ph, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < got.size


def test_chunked_query_eval_matches_unchunked(monkeypatch):
    """The query axis chunked 13 queries at a time (not a multiple of 8:
    the port's output is bool, not packed bits) equals one chunk, through
    match_batch (the budget patched) and through eval_programs."""
    rng = np.random.default_rng(3)
    texts = [f"w{a} w{b}" if i % 2 else f"w{a} OR w{b}"
             for i, (a, b) in enumerate(rng.integers(0, 40, (300, 2)))]
    texts += [_nested(rng, 3) for _ in range(40)]
    p, j = pair(texts)
    docs = [[f"w{int(x)}" for x in rng.choice(40, 10, replace=False)]
            + [f"u{int(x)}" for x in rng.choice(12, 4, replace=False)]
            for _ in range(32)]
    want = match_both(p, j, docs)
    ops, uniq = p._pack()
    inc, ph = p.build_incidence(docs, uniq)
    np.testing.assert_array_equal(
        eval_programs(ops, inc, ph, device="cpu", chunk=13), want)
    st = p._epoch()[2]
    per_q = 4 * len(docs) * (st["depth"] + port_percolator._TEMPS)
    monkeypatch.setattr(port_percolator, "_CHUNK_BUDGET_BYTES", 13 * per_q)
    np.testing.assert_array_equal(p.match_batch(docs), want)


def test_match_stream_matches_match_batch():
    """match_stream yields match_batch's results, in order; a register
    between two batches takes effect, whole, from the next batch built:
    each yielded matrix equals match_batch of its own epoch (the same
    registrations on a second percolator)."""
    rng = np.random.default_rng(9)
    texts = [f"w{a} w{b}" if i % 3 else f"w{a} NOT w{b}"
             for i, (a, b) in enumerate(
                 rng.choice(30, 2, replace=False) for _ in range(200))]
    p, j = pair(texts)
    batches = [[[f"w{int(x)}" for x in rng.choice(30, 8, replace=False)]
                + (["new", "york"] if bi % 2 else [])
                for _ in range(16 + bi)]
               for bi in range(5)]
    want = [match_both(p, j, d) for d in batches]
    got = list(p.match_stream(batches))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    later = ['"new york"', "w0 w1 w2"]
    got = []
    for out in p.match_stream(batches):
        got.append(out)
        if len(got) == 2:  # mid-stream: a phrase query, then a boolean one
            for t in later:
                p.register(t)
    # batch 2's incidence was built (its epoch taken) before batch 1 was
    # yielded; batches 3 and 4 see both new queries
    assert [g.shape[1] for g in got] == [200, 200, 200, 202, 202]
    for epoch in (200, 202):
        e, _ = pair(texts + later[: epoch - 200])
        for d, g in zip(batches, got):
            if g.shape[1] == epoch:
                np.testing.assert_array_equal(g, e.match_batch(d))
    assert got[3][:, 200].all()  # the phrase registered mid-stream matched


def test_percolator_phrase_at_position_limit():
    """Twin of test_limits_guard.py's percolator case: phrases whose
    probes touch the top of the 21-bit position field stay exact, and one
    past the field the bounds check rejects the batch."""
    p, j = pair(['"a b c"', "d"])
    lim = 1 << 21
    first = lim - 4
    docs = [["a", "b", "c"], ["d", "a", "b"], ["d", "d", "a"]]
    m = match_both(p, j, docs, first_pos=first)
    assert m[:, 0].tolist() == [True, False, False]
    assert m[:, 1].tolist() == [False, True, True]
    with pytest.raises(ValueError, match="packed-key bounds"):
        p.match_batch([["a", "b", "c"]], first_pos=lim - 3)


def test_empty_batch_and_no_queries():
    """No documents, and no registered query: empty matrices of the
    right shape."""
    p, j = pair(["a"])
    assert p.match_batch([]).shape == (0, 1)
    empty = Percolator(device="cpu")
    assert empty.match_batch([["a"]]).shape == (1, 0)
    assert JaxPercolator().match_batch([["a"]]).shape == (1, 0)


def test_cuda_percolator_raises_without_a_card():
    """Percolator() asks for the card: without one it raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        Percolator()
