# Copy of trinity_tpu/query/introspect.py; only its imports name the port.
"""Query-structure utilities applications build scoring/UX on.

Leader nodes (queries.cpp:1464-1497, 1787): the minimal set of token/
phrase nodes such that every matching document must match at least ONE of
them — the nodes an application can use to drive cheap pre-selection or
per-leader scoring boosts. For an OR both branches contribute leaders (a
match may come from either side); for an AND one branch suffices — the
normalizer orders the cheaper operand first, so the lhs leads unless it is
a ConstTrueExpr (which matches everything and therefore can't lead).

Subexpression offsets (queries.cpp:1923-1989): the starting query-token
indices of the query's independent span segments. Each leaf carries
(index, to_next_span) provenance assigned by normalize; a leaf's range is
[index, index + to_next_span) — or [index, final_index) when to_next_span
is 0 (last leaf of a sequence, queries.h:364-365). Sorting leaves by
(index asc, range end desc) and greedily skipping leaves that start inside
the current range yields one offset per independent segment — applications
use these to attribute matches back to the user's query segments
(e.g. highlighting / per-segment coverage scoring).
"""

from __future__ import annotations

from typing import List

from trinity_tpu_torch.query.ast import (
    BinOp,
    ConstTrueExpr,
    MatchSome,
    Node,
    Op,
    Phrase,
    UnaryOp,
)


def _capture_leader(n: Node, out: List[Phrase], threshold: int) -> None:
    if isinstance(n, Phrase):
        out.append(n)
        return
    if isinstance(n, BinOp):
        if n.op is Op.OR:
            _capture_leader(n.rhs, out, threshold)
            _capture_leader(n.lhs, out, threshold + 1)
        elif n.op.normalized() is Op.AND and len(out) < threshold:
            # normalized binops order the cheaper operand first; a
            # ConstTrueExpr matches everything, so it cannot lead
            if not isinstance(n.lhs, ConstTrueExpr):
                _capture_leader(n.lhs, out, threshold)
            else:
                _capture_leader(n.rhs, out, threshold)
        elif n.op is Op.NOT and len(out) < threshold:
            _capture_leader(n.lhs, out, threshold)
        return
    if isinstance(n, UnaryOp):
        if n.op.normalized() is Op.AND:
            out.append(n.expr)
        return
    # ConstTrueExpr / MatchSome / Dummy contribute no leaders


def leader_nodes(root: Node) -> List[Phrase]:
    """Token/phrase nodes at least one of which every match must contain."""
    out: List[Phrase] = []
    if root is not None:
        _capture_leader(root, out, 1)
    return out


def _collect_leaves(root: Node) -> List[Phrase]:
    """All token/phrase leaves, NOT-rhs excluded (a negation's rhs is not
    part of the match surface)."""
    out: List[Phrase] = []
    stack = [root]
    while stack:
        n = stack.pop()
        if isinstance(n, Phrase):
            out.append(n)
        elif isinstance(n, BinOp):
            stack.append(n.lhs)
            if n.op is not Op.NOT:
                stack.append(n.rhs)
        elif isinstance(n, UnaryOp):
            stack.append(n.expr)
        elif isinstance(n, ConstTrueExpr):
            stack.append(n.expr)
        elif isinstance(n, MatchSome):
            stack.extend(n.nodes)
    return out


def subexpressions_offsets(root: Node, final_index: int) -> List[int]:
    """Starting token index of each independent span segment (see module
    docstring). final_index = Query.tokens_count (the normalize() token
    counter, the query::final_index() analog)."""
    if root is None:
        return []
    leaves = _collect_leaves(root)

    def range_end(p: Phrase) -> int:
        return p.index + p.to_next_span if p.to_next_span else final_index

    leaves.sort(key=lambda p: (p.index, -range_end(p)))
    out: List[int] = []
    i = 0
    while i < len(leaves):
        upto = range_end(leaves[i])
        out.append(leaves[i].index)
        i += 1
        while i < len(leaves) and leaves[i].index < upto:
            i += 1
    return out


def subexpressions_count(root: Node, final_index: int) -> int:
    return len(subexpressions_offsets(root, final_index))
