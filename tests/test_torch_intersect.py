"""Twin of tests/test_intersect.py: the port's co-occurrence mining
(query/intersect.py) on its CPU executor, against the JAX package's
intersect / intersection_alternatives (interpret mode) on the same
documents, built by both packages' builders: the (mask, count) lists and
the alternatives must be equal, and each case checks what its original
checks. Beyond the original: all 64 tokens, so bit 63 is set."""

import numpy as np
import pytest

from torch_twins import docs_pair
from trinity_tpu.exec import Executor as JaxExecutor
from trinity_tpu.query.intersect import intersect as jax_intersect
from trinity_tpu.query.intersect import (
    intersection_alternatives as jax_alternatives,
)
from trinity_tpu_torch import Executor
from trinity_tpu_torch.query.intersect import (
    intersect,
    intersection_alternatives,
)

DOCS = {
    1: "apple iphone case",
    2: "apple iphone",
    3: "apple case",
    4: "iphone case",
    5: "apple iphone case pro",
    6: "unrelated words here",
    7: "apple iphone case",
}


@pytest.fixture(scope="module")
def exs():
    seg, ref = docs_pair({d: t.split() for d, t in DOCS.items()})
    return Executor(seg, "cpu"), JaxExecutor(ref)


def both(exs, tokens):
    got = intersect(exs[0], tokens)
    assert got == jax_intersect(exs[1], tokens)
    return got


def naive_masks(docs, tokens):
    out = {}
    for toks in docs.values():
        m = sum(1 << i for i, t in enumerate(tokens) if t in set(toks))
        if m:
            out[m] = out.get(m, 0) + 1
    return out


def test_intersect_counts(exs):
    tokens = ["apple", "iphone", "case"]
    res = dict(both(exs, tokens))
    expected = naive_masks({d: t.split() for d, t in DOCS.items()}, tokens)
    for mask, count in res.items():
        assert expected[mask] == count
    assert res[0b111] == 3  # docs 1, 5, 7


def test_dominated_masks_removed(exs):
    masks = [m for m, _ in both(exs, ["apple", "iphone", "case"])]
    # {apple} alone (mask 0b001) never occurs without iphone or case
    assert 0b001 not in masks


def test_alternatives_ordering(exs):
    tokens = ["apple", "iphone", "case", "zzz"]
    alts = intersection_alternatives(exs[0], tokens)
    assert alts == jax_alternatives(exs[1], tokens)
    assert alts[0][0] == ["apple", "iphone", "case"]
    assert alts[0][1] == 3


@pytest.mark.parametrize("n_tokens", [40, 64])
def test_intersect_many_tokens(n_tokens):
    """More than 30 tokens (the reference's second and third 30-bit
    planes; here one 64-bit word): doc 1 holds every token, docs 2 and 4
    the even ones (count 2 beats the full mask's 1, so they survive
    dedup), doc 3's last five (count 1) are dominated by the full mask.
    At 64 tokens bit 63 is set and the masks read as uint64."""
    groups = {1: range(n_tokens), 2: range(0, n_tokens, 2),
              3: range(n_tokens - 5, n_tokens), 4: range(0, n_tokens, 2)}
    seg, ref = docs_pair({d: [f"w{t}" for t in g] for d, g in groups.items()})
    toks = [f"w{i}" for i in range(n_tokens)]
    got = dict(both((Executor(seg, "cpu"), JaxExecutor(ref)), toks))
    full = (1 << n_tokens) - 1
    assert got.get(full) == 1  # doc 1
    assert got.get(sum(1 << i for i in range(0, n_tokens, 2))) == 2
    assert sum(1 << i for i in range(n_tokens - 5, n_tokens)) not in got
    assert all(0 < m < 1 << 64 for m in got)


def test_intersect_rejects_65_tokens(exs):
    with pytest.raises(ValueError, match="64"):
        intersect(exs[0], [f"w{i}" for i in range(65)])


def test_presence_words_past_the_last_document(exs):
    """presence_masks zeroes the slots past n_docs (the window's tail)."""
    from trinity_tpu_torch.ops.postings import compute_cells
    from trinity_tpu_torch.query.intersect import presence_masks

    ex = exs[0]
    cs, cn = compute_cells(ex.seg, [ex.seg.term_id("apple")])
    words = presence_masks(ex, cs, cn).numpy()
    assert words.shape == (ex.seg.n_windows * 16384,)
    assert not words[ex.seg.n_docs:].any()
    assert int(np.count_nonzero(words)) == 5
