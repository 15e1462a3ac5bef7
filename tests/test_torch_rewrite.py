"""Twin of tests/test_rewrite.py: the port's copy of the query rewriting
framework (query/rewrite.py) and the parser's introspection, on the port's
own parse trees. Every case checks what its original checks, with the
port's trees matched by the port's copy of the spec evaluator
(exec/speceval.py), and holds each rewritten query's text equal to the
JAX package's rewrite of the same query."""

import numpy as np

from trinity_tpu.oracle import OracleCorpus, oracle_match_ids
from trinity_tpu.query.ast import node_to_str as jax_node_to_str
from trinity_tpu.query.parser import parse_query as jax_parse
from trinity_tpu.query.rewrite import Alternative as JaxAlternative
from trinity_tpu.query.rewrite import AltCache as JaxAltCache
from trinity_tpu.query.rewrite import rewrite_query as jax_rewrite
from trinity_tpu_torch.exec.speceval import _eval
from trinity_tpu_torch.query.ast import (
    BinOp,
    ConstTrueExpr,
    MatchSome,
    Phrase,
    UnaryOp,
    node_to_str,
)
from trinity_tpu_torch.query.parser import parse_query
from trinity_tpu_torch.query.rewrite import (
    AltCache,
    Alternative,
    collect_runs,
    rewrite_query,
)


def table(alt):
    """The original's synonym provider, building `alt` alternatives (each
    package's Alternative)."""
    rows = {
        ("ipod",): [(["ipod", "touch"], 0.8)],
        ("mac",): [(["macintosh"], 0.9), (["apple"], 0.5)],
        ("new", "york"): [(["nyc"], 0.9)],
    }
    return lambda window: [alt(*r) for r in rows.get(tuple(window), [])]


synonyms = table(Alternative)


def rewrite_both(text, provider, jax_provider, **kw):
    """The port's rewrite of `text`; its text must equal the JAX
    package's."""
    got = rewrite_query(parse_query(text), provider, **kw)
    want = jax_rewrite(jax_parse(text), jax_provider, **kw)
    assert node_to_str(got.root) == jax_node_to_str(want.root), text
    return got, want


class _Trivial:
    """Weights and scores for a match-only evaluation."""

    def weight(self, terms):
        return 0.0

    def score(self, freq, weight):
        return np.float32(freq)


def match_ids(docs, root):
    """Ids of `docs` ({id: tokens}) that the port's tree matches, by the
    port's spec evaluator."""
    out = []
    for d in sorted(docs):
        pos = {}
        for i, t in enumerate(docs[d], start=1):
            pos.setdefault(t, []).append(i)
        if _eval(root, pos, _Trivial(), {})[0]:
            out.append(d)
    return out


def check(docs, pair, want):
    """The port's rewritten tree and the oracle over the JAX package's
    rewrite both match exactly `want`."""
    got_q, jax_q = pair
    corpus = OracleCorpus()
    for d, toks in docs.items():
        corpus.add(d, toks)
    assert match_ids(docs, got_q.root) == want
    assert oracle_match_ids(corpus, jax_q.root) == want


def test_single_token_synonym():
    r = rewrite_both("mac", synonyms, table(JaxAlternative))
    s = node_to_str(r[0].root)
    assert "macintosh" in s and "apple" in s and "mac" in s
    check({1: ["mac"], 2: ["macintosh"], 3: ["apple"], 4: ["windows"]}, r,
          [1, 2, 3])


def test_window_merge_alternative():
    """A 2-token window replaced by one token: [new york] -> nyc."""
    r = rewrite_both("new york pizza", synonyms, table(JaxAlternative))
    check({1: ["new", "york", "pizza"], 2: ["nyc", "pizza"], 3: ["nyc"],
           4: ["new", "pizza"]}, r, [1, 2])


def test_expansion_alternative():
    """One token expands to two: ipod -> ipod touch."""
    r = rewrite_both("ipod case", synonyms, table(JaxAlternative))
    check({1: ["ipod", "case"], 2: ["ipod", "touch", "case"],
           3: ["touch", "case"]}, r, [1, 2])


def test_rewrite_ctx_provenance():
    r, _ = rewrite_both("new york pizza", synonyms, table(JaxAlternative))
    found = []

    def walk(n):
        if isinstance(n, Phrase):
            if n.rewrite_ctx.range is not None:
                found.append((n.terms[0].text, n.rewrite_ctx.range,
                              n.rewrite_ctx.translation_coefficient,
                              n.rewrite_ctx.src_seq_size))
        elif isinstance(n, BinOp):
            walk(n.lhs)
            walk(n.rhs)

    walk(r.root)
    assert ("nyc", (0, 2), 0.9, 2) in found


def test_budget_caps_blowup():
    def explosive(alt):
        return lambda window: [alt([f"alt{i}-{'-'.join(window)}"])
                               for i in range(50)]

    r, _ = rewrite_both("a b c d e f g h", explosive(Alternative),
                        explosive(JaxAlternative), k=3, budget=64)
    assert node_to_str(r.root).count("alt") <= 64 + 50


def test_untouched_when_no_alternatives():
    r = rewrite_both("plain tokens here", lambda w: [], lambda w: [])
    check({1: ["plain", "tokens", "here"], 2: ["plain", "tokens"]}, r, [1])


def test_negations_not_expanded():
    r = rewrite_both("mac -ipod", synonyms, table(JaxAlternative))
    check({1: ["macintosh"], 2: ["macintosh", "ipod"]}, r, [1])


def test_collect_runs():
    q = parse_query('alpha beta "a phrase" gamma OR delta')
    texts = [[p.terms[0].text for p in run] for run in collect_runs(q)]
    assert ["alpha", "beta"] in texts


def _count_nodes(n):
    if n is None:
        return 0
    if isinstance(n, BinOp):
        return 1 + _count_nodes(n.lhs) + _count_nodes(n.rhs)
    if isinstance(n, (UnaryOp, ConstTrueExpr)):
        return 1 + _count_nodes(n.expr)
    if isinstance(n, MatchSome):
        return 1 + sum(_count_nodes(c) for c in n.nodes)
    return 1


def test_span_sharing_linear_blowup():
    """Span sharing (queries_rewrite.h:16-182): node count grows linearly
    with run length, and no alternative is lost to the budget."""
    def per_token(alt):
        return lambda w: ([alt(tokens=(f"alt_{w[0]}",))] if len(w) == 1
                          else [])

    sizes = []
    for n in (4, 8, 12):
        text = " ".join(f"t{i}" for i in range(n))
        r, _ = rewrite_both(text, per_token(Alternative),
                            per_token(JaxAlternative), k=3, budget=256)
        s = node_to_str(r.root)
        assert all(f"alt_t{i}" in s for i in range(n)), s
        sizes.append(_count_nodes(r.root))
    assert sizes[1] <= 2 * sizes[0] + 8, sizes
    assert sizes[2] <= 3 * sizes[0] + 12, sizes


def test_span_sharing_overlap_still_branches():
    """Overlapping spans still branch and stay correct."""
    def alts(alt):
        def provider(w):
            if w == ("new", "york"):
                return [alt(tokens=("ny",))]
            if w == ("york", "city"):
                return [alt(tokens=("yc",))]
            return []
        return provider

    r = rewrite_both("new york city", alts(Alternative), alts(JaxAlternative),
                     k=2)
    check({1: ["ny", "city"], 2: ["new", "yc"], 3: ["new", "york", "city"],
           4: ["ny", "yc"], 5: ["new", "york"]}, r, [1, 2, 3])


def test_altcache_cross_call_memo():
    """AltCache (queries_rewrite.h:187-243): repeated windows never
    re-invoke the provider, per logical index; results stay equal to
    uncached (and to the JAX package's)."""
    calls = []

    def provider(w):
        calls.append(tuple(w))
        return synonyms(w)

    cache = AltCache()
    r1 = rewrite_query(parse_query("new york mac"), provider, cache=cache)
    n_first = len(calls)
    assert n_first > 0
    r2 = rewrite_query(parse_query("new york mac"), provider, cache=cache)
    assert len(calls) == n_first
    assert node_to_str(r2.root) == node_to_str(r1.root)
    rewrite_query(parse_query("new york city"), provider, cache=cache)
    assert ("new", "york") not in calls[n_first:]
    before = len(calls)
    rewrite_query(parse_query("new york mac"), provider, cache=cache,
                  logical_index=7)
    assert len(calls) > before
    r0 = rewrite_query(parse_query("new york mac"), synonyms)
    assert node_to_str(r0.root) == node_to_str(r1.root)
    want = jax_rewrite(jax_parse("new york mac"), table(JaxAlternative),
                       cache=JaxAltCache())
    assert node_to_str(r1.root) == jax_node_to_str(want.root)


def test_leader_nodes():
    """leader_nodes (queries.cpp:1464-1497), equal to the JAX package's."""
    def leads(parse, qs):
        return sorted(" ".join(t.text for t in p.terms)
                      for p in parse(qs).leader_nodes())

    want = {"apple": ["apple"], "apple banana": ["apple"],
            "apple OR banana": ["apple", "banana"],
            "(apple OR banana) cherry": ["apple", "banana"],
            '"red apple" OR pear': ["pear", "red apple"],
            "apple NOT banana": ["apple"], "apple <case>": ["apple"]}
    for qs, w in want.items():
        assert leads(parse_query, qs) == w == leads(jax_parse, qs), qs


def test_subexpressions_offsets():
    """subexpressions_offsets (queries.cpp:1923-1989), equal to the JAX
    package's."""
    want = {"apple banana": [0, 1], "apple OR banana": [0],
            '"new york" city': [0, 2], "apple NOT banana": [0],
            "(apple OR banana) cherry": [0, 1], "": []}
    for qs, w in want.items():
        got = parse_query(qs).subexpressions_offsets()
        assert got == w == jax_parse(qs).subexpressions_offsets(), qs
    q = parse_query("(apple OR banana) cherry")
    assert q.subexpressions_count() == 2
