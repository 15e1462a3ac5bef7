# Copy of trinity_tpu/query/rewrite.py; only its imports name the port.
"""Query rewriting: synonyms / contractions / expansions.

The analog of queries_rewrite.h: rewrite_query() walks each maximal AND-run
of tokens (process_runs, queries.h:692-778), slides windows of up to K
tokens, asks an application-provided alternatives source for each window,
and materializes a rewritten AST in which every alternative carries
provenance metadata — rewrite_ctx{range, translationCoefficient,
srcSeqSize} (queries.h:392-438) — used later for scoring.

Where the reference builds an explicit `flow` graph of spans
(queries_rewrite.h:16-182) and renders it back to nodes, this implementation
uses the equivalent DAG formulation directly: for a run t_0..t_{n-1},

    expr(i) = OR over edges (i -> j, alt) of [alt AND expr(j)]

with one edge per original token (coefficient 1) plus one edge per
application alternative spanning [i, j), j - i <= K. The result is
linear-size in the number of alternatives, like the reference's flow graph.
A node budget caps blow-up (queries_rewrite.h:981-1095); alternatives are
cached per window (gen_ctx analog, queries_rewrite.h:187-243).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from trinity_tpu_torch.query.ast import (
    BinOp,
    ConstTrueExpr,
    MatchSome,
    Node,
    Op,
    Phrase,
    RewriteCtx,
    Term,
    UnaryOp,
)
from trinity_tpu_torch.query.parser import Query


@dataclass
class Alternative:
    """One rewrite of a token window: a replacement token sequence (or
    phrase) and its relevance coefficient."""

    tokens: Sequence[str]
    coefficient: float = 1.0
    as_phrase: bool = False
    flags: int = 0


# alternatives source: (window tokens) -> list of Alternative
AltProvider = Callable[[Sequence[str]], List[Alternative]]


class AltCache:
    """Cross-query alternatives memo, keyed per LOGICAL INDEX — the
    gen_ctx analog (queries_rewrite.h:187-243): the reference keeps one
    generation context per logical index so the application's alternatives
    lambda is invoked once per distinct token window, not once per
    overlapping window per query. An application serving many queries
    against the same index passes one AltCache to every rewrite_query call
    (providers for different logical indices don't collide: the index id
    is part of the key)."""

    def __init__(self):
        self._m: Dict[Tuple[int, Tuple[str, ...]], List[Alternative]] = {}

    def get(self, logical_index: int, window: Tuple[str, ...]):
        return self._m.get((logical_index, window))

    def put(self, logical_index: int, window, alts: List[Alternative]):
        self._m[(logical_index, window)] = alts

    def __len__(self):
        return len(self._m)


@dataclass
class _RunCtx:
    budget: int
    provider: AltProvider
    k: int
    shared: Optional[AltCache] = None  # cross-call (per logical index)
    logical_index: int = 0
    cache: Dict[Tuple[str, ...], List[Alternative]] = field(default_factory=dict)

    def alternatives(self, window: Tuple[str, ...]) -> List[Alternative]:
        if window not in self.cache:
            hit = (
                self.shared.get(self.logical_index, window)
                if self.shared is not None
                else None
            )
            if hit is None:
                hit = self.provider(window) or []
                if self.shared is not None:
                    self.shared.put(self.logical_index, window, hit)
            self.cache[window] = hit
        return self.cache[window]


def collect_runs(query: Query) -> List[List[Phrase]]:
    """Public process_runs analog (queries.h:692-778): the maximal AND-runs
    of single tokens, in query order — the unit rewrites operate on."""
    runs: List[List[Phrase]] = []
    cur: List[Phrase] = []
    if query.root is not None:
        _collect_runs(query.root, runs, cur)
        _flush(runs, cur)
    return runs


def _collect_runs(n: Node, runs: List[List[Phrase]], current: List[Phrase]):
    """Maximal AND-chained single-token sequences. Tokens under OR/NOT/
    phrases terminate runs."""
    if isinstance(n, Phrase):
        if not n.is_phrase and n.size == 1:
            current.append(n)
        else:
            _flush(runs, current)
        return
    if isinstance(n, BinOp):
        if n.op.normalized() is Op.AND:
            _collect_runs(n.lhs, runs, current)
            _collect_runs(n.rhs, runs, current)
            return
        if n.op is Op.NOT:
            _collect_runs(n.lhs, runs, current)
            _flush(runs, current)
            return
        _flush(runs, current)
        sub: List[Phrase] = []
        _collect_runs(n.lhs, runs, sub)
        _flush(runs, sub)
        sub = []
        _collect_runs(n.rhs, runs, sub)
        _flush(runs, sub)
        return
    if isinstance(n, (UnaryOp, ConstTrueExpr)):
        _flush(runs, current)
        return
    if isinstance(n, MatchSome):
        _flush(runs, current)
        return
    _flush(runs, current)


def _flush(runs, current):
    if current:
        runs.append(list(current))
        current.clear()


def _make_node(
    alt: Alternative, base_index: int, span: int, ctx_nodes: List[int]
) -> Node:
    """Materialize one alternative as Token-AND-chain or Phrase, stamped
    with rewrite_ctx provenance."""
    rc = RewriteCtx(
        range=(base_index, base_index + span),
        translation_coefficient=alt.coefficient,
        src_seq_size=span,
    )
    if alt.as_phrase:
        ctx_nodes[0] += len(alt.tokens)
        return Phrase(
            terms=[Term(t) for t in alt.tokens],
            is_phrase=True,
            flags=alt.flags,
            rewrite_ctx=rc,
        )
    nodes = [
        Phrase(
            terms=[Term(t)],
            is_phrase=False,
            flags=alt.flags,
            rewrite_ctx=RewriteCtx(
                range=rc.range,
                translation_coefficient=alt.coefficient,
                src_seq_size=span,
            ),
        )
        for t in alt.tokens
    ]
    ctx_nodes[0] += len(nodes)
    out = nodes[0]
    for nn in nodes[1:]:
        out = BinOp(Op.AND, out, nn)
    return out


def _rewrite_run(tokens: List[Phrase], ctx: _RunCtx) -> Optional[Node]:
    """DAG construction with SPAN SHARING (the flow graph's core property,
    queries_rewrite.h:16-182): parallel alternatives over the same region
    join the same downstream flow instead of duplicating it.

    Edges (i -> j, alt) are collected once; a position c that NO span
    crosses is a cut point, and the run factors as an AND of independent
    segments there — so a segment's subtree materializes ONCE, shared by
    every alternative to its left, exactly like flows that merge back into
    the shared continuation. Only inside a segment (genuinely overlapping
    spans) does the expansion branch:  expr(i) = OR over edges out of i of
    [alt AND expr(j)], bounded by the node budget
    (queries_rewrite.h:981-1095). For non-overlapping alternatives the
    result is LINEAR in the number of alternatives (see
    tests/test_rewrite.py node-count comparison) where the unshared
    expansion was exponential in run length."""
    n = len(tokens)
    texts = [p.terms[0].text for p in tokens]
    base = tokens[0].index if tokens else 0
    node_count = [0]

    # collect every alternative edge once (window-cached provider)
    edges: Dict[int, List[Tuple[int, Alternative]]] = {}
    for i in range(n):
        for j in range(i + 1, min(n, i + ctx.k) + 1):
            window = tuple(texts[i:j])
            for alt in ctx.alternatives(window):
                if list(alt.tokens) == list(window) and not alt.as_phrase:
                    continue  # identity, covered by the original token edge
                edges.setdefault(i, []).append((j, alt))

    # cut points: positions no span crosses -> independent AND segments
    cross = set()
    for i, lst in edges.items():
        for j, _ in lst:
            cross.update(range(i + 1, j))
    cuts = [0] + [c for c in range(1, n) if c not in cross] + [n]

    def orig_node(i: int) -> Node:
        # original token edge (coefficient 1, identity rewrite)
        return Phrase(
            terms=[Term(texts[i])],
            is_phrase=False,
            rep=tokens[i].rep,
            flags=tokens[i].flags,
            app_phrase_id=tokens[i].app_phrase_id,
        )

    def expr(i: int, stop: int) -> Optional[Node]:
        # branching expansion WITHIN a segment: every path materialized
        # (the AST is a mutable tree; normalize rewrites nodes in place),
        # bounded by the node budget — but segments are maximal overlap
        # groups, so this only pays for genuinely overlapping spans
        if i >= stop:
            return None
        choices: List[Node] = []
        tail = expr(i + 1, stop)
        orig = orig_node(i)
        choices.append(BinOp(Op.AND, orig, tail) if tail is not None else orig)
        for j, alt in edges.get(i, ()):
            if node_count[0] >= ctx.budget:
                break
            node = _make_node(alt, base + i, j - i, node_count)
            tail = expr(j, stop)
            choices.append(
                BinOp(Op.AND, node, tail) if tail is not None else node
            )
        out = choices[0]
        for c in choices[1:]:
            out = BinOp(Op.OR, out, c)
        return out

    parts = [expr(a, b) for a, b in zip(cuts[:-1], cuts[1:])]
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = BinOp(Op.AND, out, p)
    return out


def rewrite_query(
    query: Query,
    provider: AltProvider,
    k: int = 3,
    budget: int = 256,
    cache: Optional[AltCache] = None,
    logical_index: int = 0,
) -> Query:
    """rewrite_query analog (queries_rewrite.h:992-997): returns a NEW
    normalized query with every AND-run of tokens expanded by the
    application's alternatives. The original query is not modified.
    cache/logical_index: optional cross-call AltCache (gen_ctx analog) so
    repeated/overlapping windows never re-invoke the provider."""
    from trinity_tpu_torch.query.ast import copy_node

    if query.root is None:
        return Query(root=None)
    root = copy_node(query.root)
    ctx = _RunCtx(
        budget=budget, provider=provider, k=k,
        shared=cache, logical_index=logical_index,
    )

    def transform(node: Node) -> Node:
        if isinstance(node, Phrase):
            if not node.is_phrase and node.size == 1:
                rewritten = _rewrite_run([node], ctx)
                return rewritten if rewritten is not None else node
            return node
        if isinstance(node, BinOp):
            if node.op.normalized() is Op.AND:
                # collect the full AND-token chain rooted here
                chain: List[Phrase] = []
                rest: List[Node] = []

                def split(m: Node):
                    if isinstance(m, BinOp) and m.op.normalized() is Op.AND:
                        split(m.lhs)
                        split(m.rhs)
                    elif isinstance(m, Phrase) and not m.is_phrase and m.size == 1:
                        chain.append(m)
                    else:
                        rest.append(transform(m))

                split(node)
                parts: List[Node] = []
                if chain:
                    rw = _rewrite_run(chain, ctx)
                    if rw is not None:
                        parts.append(rw)
                parts.extend(rest)
                out = parts[0]
                for p in parts[1:]:
                    out = BinOp(Op.AND, out, p)
                return out
            node.lhs = transform(node.lhs)
            node.rhs = transform(node.rhs)
            return node
        if isinstance(node, UnaryOp):
            return node  # negated/required-prefix terms are not expanded
        if isinstance(node, ConstTrueExpr):
            node.expr = transform(node.expr)
            return node
        if isinstance(node, MatchSome):
            node.nodes = [transform(c) for c in node.nodes]
            return node
        return node

    q = Query(root=transform(root))
    return q.normalize()
