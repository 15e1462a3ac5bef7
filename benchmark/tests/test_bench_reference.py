"""The plain reference against a brute-force scorer on tiny corpora."""

import math

import numpy as np
import pytest
import torch

from benchmark.corpus import Source
from benchmark.reference import Reference

VOCAB = 12


def brute_force(sources, spec, k):
    """Top-k [(app id, score)] by looping over every document in Python."""
    docs = []  # (app id, generation, tokens)
    for s in sources:
        for i, d in enumerate(s.ids):
            toks = s.tokens[s.bounds[i]: s.bounds[i + 1]]
            docs.append((int(d), s.generation, [int(t) for t in toks]))
    n = len(docs)

    def df(t):
        return sum(1 for _, _, toks in docs if t in toks)

    def weight(terms):
        return sum(math.log(1.0 + (n - df(t) + 0.5) / (df(t) + 0.5))
                   for t in terms)

    def freq(toks, terms):
        w = len(terms)
        return sum(1 for i in range(len(toks) - w + 1)
                   if toks[i: i + w] == list(terms))

    def ev(node, toks):
        kind = node[0]
        if kind in ("term", "phrase"):
            terms = (node[1],) if kind == "term" else node[1]
            f = freq(toks, terms)
            return (f > 0), (weight(terms) * f / (f + 1.2) if f else 0.0)
        if kind == "not":
            (m, s), (m2, _) = ev(node[1], toks), ev(node[2], toks)
            return (m and not m2), (s if m and not m2 else 0.0)
        kids = [ev(c, toks) for c in (node[2] if kind == "some" else node[1])]
        hits = sum(m for m, _ in kids)
        total = 0.0
        for m, s in kids:  # left to right, as the scheme accumulates
            if m:
                total += s
        ok = {"and": hits == len(kids), "or": hits > 0,
              "some": kind == "some" and hits >= node[1]}[kind]
        return ok, (total if ok else 0.0)

    shadowed = {}
    for s in sources:
        for d in s.shadows:
            shadowed[int(d)] = max(shadowed.get(int(d), 0), s.generation)
    out = []
    for app, gen, toks in docs:
        if shadowed.get(app, 0) > gen:
            continue
        m, sc = ev(spec, toks)
        if m:
            out.append((app, sc))
    out.sort(key=lambda r: (-r[1], r[0]))
    return out[:k]


def make_source(rng, ids, gen, shadows=(), dup_every=5):
    """Documents of 3-8 tokens over VOCAB terms; every `dup_every`-th
    repeats the one before it, so equal scores (ties) are common."""
    docs = []
    for i in range(len(ids)):
        if docs and i % dup_every == 0:
            docs.append(list(docs[-1]))
        else:
            docs.append(list(rng.integers(0, VOCAB, rng.integers(3, 9))))
    bounds = np.zeros(len(docs) + 1, np.int64)
    np.cumsum([len(d) for d in docs], out=bounds[1:])
    tokens = np.array([t for d in docs for t in d], np.int32)
    return Source(np.asarray(ids, np.int64), bounds, tokens,
                  np.sort(np.asarray(shadows, np.int64)), gen)


def three_generations(seed=7):
    rng = np.random.default_rng(seed)
    base = make_source(rng, np.arange(60), 1)
    upd = rng.choice(60, 12, replace=False)
    erased = np.setdiff1d(rng.choice(60, 20, replace=False), upd)[:6]
    g2_ids = np.sort(np.concatenate([upd, np.arange(60, 66)]))
    g2 = make_source(rng, g2_ids, 2, shadows=upd)
    g3 = Source(np.zeros(0, np.int64), np.zeros(1, np.int64),
                np.zeros(0, np.int32), np.sort(erased.astype(np.int64)), 3)
    return [base, g2, g3]


T = lambda t: ("term", t)  # noqa: E731
SPECS = [
    T(0), T(5), T(11),
    ("phrase", (1, 2)), ("phrase", (3, 4, 5)), ("phrase", (0, 0)),
    ("and", (T(1), T(2))), ("and", (T(0), T(3), T(6), T(9))),
    ("or", (T(2), T(7), T(10))), ("or", (T(0), T(1), T(2), T(3), T(4), T(5))),
    ("not", T(1), T(2)), ("not", ("and", (T(3), T(4))), T(5)),
    ("some", 2, (T(1), T(4), T(7), T(10))),
    ("some", 3, (T(0), T(2), T(4), T(6))),
    ("or", (("and", (T(1), T(3))), ("and", (T(2), T(4))))),
    ("and", (("phrase", (1, 2)), T(6))), ("or", (("phrase", (2, 3)), T(8))),
]


@pytest.mark.parametrize("which", ["one", "three"])
def test_reference_equals_brute_force(which):
    if which == "one":
        sources = [make_source(np.random.default_rng(3), np.arange(200), 1)]
    else:
        sources = three_generations()
    ref = Reference(sources, VOCAB, "cpu")
    ties = 0
    for spec in SPECS:
        for k in (3, 10):
            want = brute_force(sources, spec, k)
            dense, ids, scores = ref.search(spec, k)
            assert ids.tolist() == [a for a, _ in want], spec
            np.testing.assert_allclose(scores.numpy(), [s for _, s in want],
                                       rtol=1e-12)
            for a, s in want:
                assert dense[ref.doc_of_app[a]] == pytest.approx(s, rel=1e-12)
            sc = [s for _, s in want]
            ties += sum(x == y for x, y in zip(sc, sc[1:]))
    assert ties > 10  # the tie-break (app id ascending) was exercised


def test_collection_semantics():
    sources = three_generations()
    ref = Reference(sources, VOCAB, "cpu")
    base, g2, g3 = sources
    live_apps = set(ref.app[ref.live].tolist())
    assert not live_apps & set(g3.shadows.tolist())
    assert len(live_apps) == 60 + 6 - len(g3.shadows)
    # an updated id is served by its newest copy only
    for d in g2.shadows.tolist():
        doc = int(ref.doc_of_app[d])
        assert doc >= len(base.ids)
    # statistics count every raw source, shadowed copies included
    assert ref.n_docs == len(base.ids) + len(g2.ids)


def test_bfloat16_control_differs():
    sources = [make_source(np.random.default_rng(4), np.arange(300), 1)]
    hi = Reference(sources, VOCAB, "cpu")
    lo = Reference(sources, VOCAB, "cpu", dtype=torch.bfloat16)
    spec = ("or", (T(0), T(1), T(2), T(3)))
    _, _, s_hi = hi.search(spec, 10)
    _, _, s_lo = lo.search(spec, 10)
    assert (s_hi - s_lo).abs().max() / s_hi.max() > 1e-4
