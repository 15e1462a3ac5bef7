"""Twin of tests/test_fuzz_parity.py: random ASTs (MatchSome with min > 1,
ConstTrueExpr, phrase nodes — shapes the parser cannot produce) on the
port's CPU executor against the oracle. Each tree is drawn twice from the
same seed, once in each package's AST classes; each is checked three
ways: search (ids exactly, scores within 2 ulp), match_ids, and
search_pruned(chunk_windows=2) equal to search."""

import numpy as np
import pytest

from test_torch_exec_e2e import make_corpus
from trinity_tpu.oracle import oracle_match_ids, oracle_search
from trinity_tpu.query import ast as jax_ast
from trinity_tpu_torch import Executor
from trinity_tpu_torch.query import ast


def random_tree(rng, vocab, depth, a):
    """The original's random_tree over the AST module `a`."""
    r = rng.random()
    if depth <= 0 or r < 0.35:
        if rng.random() < 0.2:
            terms = [a.Term(f"t{int(x)}") for x in rng.integers(0, vocab, 2)]
            return a.Phrase(terms=terms, is_phrase=True)
        return a.Token(f"t{int(rng.integers(0, vocab))}")
    kind = rng.integers(0, 6)
    sub = lambda: random_tree(rng, vocab, depth - 1, a)
    if kind == 0:
        return a.BinOp(a.Op.AND, sub(), sub())
    if kind == 1:
        return a.BinOp(a.Op.OR, sub(), sub())
    if kind == 2:
        return a.BinOp(a.Op.NOT, sub(), sub())
    if kind == 3:
        return a.ConstTrueExpr(sub())
    if kind == 4:
        n = int(rng.integers(2, 5))
        return a.MatchSome(nodes=[sub() for _ in range(n)],
                           min=int(rng.integers(1, n + 1)))
    return a.UnaryOp(a.Op.NOT, a.Token(f"t{int(rng.integers(0, vocab))}"))


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(99)
    seg, oc = make_corpus(rng, n_docs=400, vocab=40, doc_len_rng=(3, 25),
                          id_stride=2)
    return Executor(seg, "cpu"), oc


@pytest.mark.parametrize("seed", range(30))
def test_random_tree_parity(corpus, seed):
    ex, oc = corpus
    root = random_tree(np.random.default_rng(seed), 40, 3, ast)
    ref = random_tree(np.random.default_rng(seed), 40, 3, jax_ast)
    assert repr(root) == repr(ref)
    got = ex.search(root, k=10)
    want = oracle_search(oc, ref, k=10)
    assert [r.doc_id for r in got] == [d for d, _ in want], repr(root)
    np.testing.assert_allclose(
        [r.score for r in got], [s for _, s in want], rtol=2.4e-7, atol=0
    )
    np.testing.assert_array_equal(
        ex.match_ids(root), np.array(oracle_match_ids(oc, ref), np.uint32)
    )
    pruned = ex.search_pruned(root, k=10, chunk_windows=2)
    assert [(r.doc_id, r.score) for r in pruned] == [
        (r.doc_id, r.score) for r in got
    ], repr(root)
