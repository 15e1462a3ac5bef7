# Copy of trinity_tpu/query/normalize.py; only its imports name the port.
"""Query normalization: algebraic simplification to fixpoint + index assignment.

Re-implements the reference's normalize_root pipeline (queries.cpp:954-1348):

1. ``normalize``/``normalize_bin`` rules run to fixpoint (ctx.updates loop,
   queries.cpp:1251-1260): dummy GC, ConstFalse folding, duplicate collapse
   ([apple OR apple] -> [apple]), NOT contradictions ([foo AND bar NOT foo]
   -> FALSE), unary-op simplification, MatchSome pruning
   (queries.cpp:576-1034).
2. Root validation: token cap, dummy/const-false root, unary-NOT root and
   no-leader-token queries all nullify the query (queries.cpp:1262-1295).
3. ``assign_query_indices`` computes each token/phrase's query ``index`` and
   ``toNextSpan`` (distance to the next AND-sibling group), with OR branches
   sharing a start index and NOT gaps of 4 (queries.cpp:1100-1247) — the
   metadata that powers proximity scoring and rewrites.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from trinity_tpu_torch.limits import MAX_QUERY_TOKENS
from trinity_tpu_torch.query.ast import (
    BinOp,
    ConstFalse,
    ConstTrueExpr,
    Dummy,
    MatchSome,
    Node,
    Op,
    Phrase,
    UnaryOp,
)

MATCH_SOME_INDEX = 0xFFFF  # queries.cpp:1168


@dataclass
class _Ctx:
    updates: int = 0
    tokens_cnt: int = 0


def _is_unary(n: Node) -> bool:
    return isinstance(n, Phrase)


def _same(a: Node, b: Node) -> bool:
    return (
        isinstance(a, Phrase)
        and isinstance(b, Phrase)
        and a.is_phrase == b.is_phrase
        and a.same(b)
    )


def _is_dummy(n):
    return isinstance(n, Dummy)


def _is_false(n):
    return isinstance(n, ConstFalse)


def _normalize_bin(n: BinOp, ctx: _Ctx) -> Node:
    """normalize_bin (queries.cpp:576-934), rule-for-rule."""
    n.lhs = _normalize(n.lhs, ctx)
    n.rhs = _normalize(n.rhs, ctx)
    lhs, rhs = n.lhs, n.rhs
    op = n.op

    def upd(x: Node) -> Node:
        ctx.updates += 1
        return x

    if _is_dummy(lhs) and _is_dummy(rhs):
        return upd(Dummy())
    if _is_dummy(rhs):
        return upd(lhs)
    if _is_dummy(lhs):
        return upd(rhs)

    # [foo OR bar NOT foo] => [bar]
    if (
        op is Op.NOT
        and isinstance(lhs, BinOp)
        and lhs.op is Op.OR
        and _is_unary(lhs.lhs)
        and _is_unary(rhs)
        and _same(lhs.lhs, rhs)
    ):
        return upd(lhs.rhs)
    # [foo AND bar NOT foo] => FALSE
    if (
        op is Op.NOT
        and isinstance(lhs, BinOp)
        and lhs.op.normalized() is Op.AND
        and _is_unary(lhs.lhs)
        and _is_unary(rhs)
        and _same(lhs.lhs, rhs)
    ):
        return upd(ConstFalse())
    # [foo NOT bar NOT foo] => FALSE
    if (
        op is Op.NOT
        and isinstance(lhs, BinOp)
        and lhs.op.normalized() is Op.NOT
        and _is_unary(lhs.lhs)
        and _is_unary(rhs)
        and _same(lhs.lhs, rhs)
    ):
        return upd(ConstFalse())

    if _is_false(lhs):
        if op in (Op.AND, Op.STRICT_AND, Op.NOT):
            return upd(ConstFalse())
        if op is Op.OR:
            return upd(ConstFalse() if _is_false(rhs) else rhs)
    if _is_false(rhs):
        if op in (Op.AND, Op.STRICT_AND):
            return upd(ConstFalse())
        if op in (Op.OR, Op.NOT):
            return upd(lhs)

    # [phrase OP samephrase]
    if _same(lhs, rhs) and op is not Op.AND:
        if op is Op.STRICT_AND:
            return upd(lhs)
        if op is Op.NOT:
            return upd(ConstFalse())
        if op is Op.OR:
            return upd(lhs)

    # rhs is +APPLE / unary AND
    if (
        isinstance(rhs, UnaryOp)
        and rhs.op in (Op.AND, Op.STRICT_AND)
        and _is_unary(lhs)
        and _is_unary(rhs.expr)
        and _same(lhs, rhs.expr)
    ):
        if op is Op.NOT:  # [APPLE NOT +APPLE]
            return upd(ConstFalse())
        return upd(rhs)  # [APPLE OR +APPLE], [APPLE AND +APPLE]

    if isinstance(lhs, UnaryOp):
        if (
            isinstance(rhs, UnaryOp)
            and lhs.op == rhs.op
            and lhs.op == op
            and _same(lhs.expr, rhs.expr)
        ):
            return upd(UnaryOp(op, lhs.expr))
        if (
            lhs.op in (Op.AND, Op.STRICT_AND)
            and _is_unary(rhs)
            and _same(rhs, lhs.expr)
        ):
            if op is Op.NOT:  # [+APPLE NOT APPLE]
                return upd(ConstFalse())
            return upd(lhs)  # [+APPLE OR APPLE], [+APPLE AND APPLE]

    # [NOT apple NOT apple]
    if (
        op is Op.NOT
        and isinstance(lhs, UnaryOp)
        and lhs.op is Op.NOT
        and _same(lhs.expr, rhs)
    ):
        return upd(lhs)

    # lift NOT out of AND/OR: a AND -b => a NOT b (queries.cpp:795-824)
    if op in (Op.AND, Op.OR):
        if isinstance(rhs, UnaryOp) and rhs.op is Op.NOT:
            n.op = Op.NOT
            n.rhs = rhs.expr
            ctx.updates += 1
            return n
        if isinstance(lhs, UnaryOp) and lhs.op is Op.NOT:
            n.op = Op.NOT
            n.lhs = rhs
            n.rhs = lhs.expr
            ctx.updates += 1
            return n

    # dedup against the rightmost of an lhs chain (queries.cpp:860-897)
    if isinstance(lhs, BinOp) and _is_unary(rhs) and _is_unary(lhs.rhs) and _same(rhs, lhs.rhs):
        if lhs.op == op:
            # [macbook OR macbook OR macbook] => [macbook OR macbook]
            n.rhs = Dummy()
            ctx.updates += 1
            return n
        if lhs.op is Op.NOT and op in (Op.AND, Op.STRICT_AND):
            n.rhs = ConstFalse()
            ctx.updates += 1
            return n
        if op is Op.NOT and lhs.op in (Op.AND, Op.STRICT_AND):
            return upd(ConstFalse())

    # [apple OR "macbook pro" apple] => ["macbook pro" apple]
    if (
        op.normalized() is Op.AND
        and isinstance(lhs, BinOp)
        and _is_unary(rhs)
        and lhs.op is Op.OR
        and _is_unary(lhs.lhs)
        and _same(rhs, lhs.lhs)
    ):
        n.lhs = lhs.rhs
        ctx.updates += 1
        return n

    # [warcraft NOT (warcraft OR apple)] => FALSE
    if (
        op is Op.NOT
        and isinstance(rhs, BinOp)
        and _is_unary(lhs)
        and _is_unary(rhs.lhs)
        and _same(lhs, rhs.lhs)
    ):
        return upd(ConstFalse())

    # [warcraft (warcraft OR apple)] => [warcraft AND apple]
    if (
        op.normalized() is Op.AND
        and isinstance(rhs, BinOp)
        and _is_unary(lhs)
        and _is_unary(rhs.lhs)
        and _same(lhs, rhs.lhs)
    ):
        n.rhs = rhs.rhs
        ctx.updates += 1
        return n

    # iphone NOT (ipad OR iphone) => FALSE
    if (
        op is Op.NOT
        and _is_unary(lhs)
        and isinstance(rhs, BinOp)
        and rhs.op is Op.OR
        and (
            (_is_unary(rhs.lhs) and _same(lhs, rhs.lhs))
            or (_is_unary(rhs.rhs) and _same(lhs, rhs.rhs))
        )
    ):
        return upd(ConstFalse())

    # foo NOT (ipad AND foo) => FALSE
    if (
        op is Op.NOT
        and _is_unary(lhs)
        and isinstance(rhs, BinOp)
        and _is_unary(rhs.rhs)
        and _same(lhs, rhs.rhs)
    ):
        return upd(ConstFalse())

    return n


def _normalize(n: Node, ctx: _Ctx) -> Node:
    """normalize (queries.cpp:954-1034)."""
    if isinstance(n, BinOp):
        return _normalize_bin(n, ctx)
    if isinstance(n, Phrase):
        if n.size == 0:
            ctx.updates += 1
            return Dummy()
        ctx.tokens_cnt += n.size
        return n
    if isinstance(n, ConstTrueExpr):
        n.expr = _normalize(n.expr, ctx)
        if _is_dummy(n.expr) or _is_false(n.expr):
            ctx.updates += 1
            return Dummy()
        return n
    if isinstance(n, MatchSome):
        kept: List[Node] = []
        for c in n.nodes:
            c = _normalize(c, ctx)
            if _is_dummy(c) or _is_false(c):
                ctx.updates += 1
            else:
                kept.append(c)
        n.nodes = kept
        if n.min > len(n.nodes):
            ctx.updates += 1
            return ConstFalse()
        if len(n.nodes) == 1:
            ctx.updates += 1
            return n.nodes[0]
        return n
    if isinstance(n, UnaryOp):
        n.expr = _normalize(n.expr, ctx)
        if _is_dummy(n.expr):
            ctx.updates += 1
            return Dummy()
        if n.op in (Op.AND, Op.OR):
            ctx.updates += 1
            return n.expr
        return n
    return n  # Dummy, ConstFalse


def has_leader_tokens(n: Node) -> bool:
    """any_leader_tokens analog (queries.cpp:1464-1501): is there at least
    one positively-required token that can drive iteration? ConstTrueExpr
    subtrees are optional and never lead; NOT right sides never lead."""
    if isinstance(n, Phrase):
        return True
    if isinstance(n, BinOp):
        if n.op is Op.NOT:
            return has_leader_tokens(n.lhs)
        return has_leader_tokens(n.lhs) or has_leader_tokens(n.rhs)
    if isinstance(n, UnaryOp):
        return n.op is not Op.NOT and has_leader_tokens(n.expr)
    if isinstance(n, MatchSome):
        return any(has_leader_tokens(c) for c in n.nodes)
    return False  # ConstTrueExpr, Dummy, ConstFalse


@dataclass
class _AssignCtx:
    next_index: int = 0
    stack: List[List[Phrase]] = None
    phrases: List[Phrase] = None

    def __post_init__(self):
        self.stack = []
        self.phrases = []


def _assign_indices(n: Node, ctx: _AssignCtx) -> None:
    """assign_query_indices (queries.cpp:1100-1247)."""
    if isinstance(n, Phrase):
        ctx.phrases.append(n)
        if ctx.stack:
            ctx.stack[-1].append(n)
        n.index = ctx.next_index
        ctx.next_index += n.size
    elif isinstance(n, UnaryOp):
        _assign_indices(n.expr, ctx)
    elif isinstance(n, ConstTrueExpr):
        _assign_indices(n.expr, ctx)
    elif isinstance(n, MatchSome):
        def mark(m: Node):
            if isinstance(m, Phrase):
                m.index = MATCH_SOME_INDEX
            elif isinstance(m, BinOp):
                mark(m.lhs)
                mark(m.rhs)
            elif isinstance(m, (UnaryOp, ConstTrueExpr)):
                mark(m.expr)
            elif isinstance(m, MatchSome):
                for c in m.nodes:
                    mark(c)

        for c in n.nodes:
            mark(c)
    elif isinstance(n, BinOp):
        if n.op in (Op.AND, Op.STRICT_AND):
            u: List[Phrase] = []
            ctx.stack.append(u)
            _assign_indices(n.lhs, ctx)
            ctx.stack.pop()
            for p in u:
                p.to_next_span = ctx.next_index - p.index
            _assign_indices(n.rhs, ctx)
        elif n.op is Op.NOT:
            _assign_indices(n.lhs, ctx)
            ctx.next_index += 4  # gap so RHS isn't adjacent (queries.cpp:1226)
        else:  # OR: branches share the start index, advance by the max
            saved = ctx.next_index
            _assign_indices(n.lhs, ctx)
            max_l = ctx.next_index
            ctx.next_index = saved
            _assign_indices(n.rhs, ctx)
            ctx.next_index = max(max_l, ctx.next_index)


def _trim(n: Node, budget: List[int]) -> Node:
    """Drop tokens past the MaxQueryTokens budget in query order, replacing
    them with dummies (query::trim, queries.cpp:1503-1524: nodes beyond the
    cap are set_dummy() and the query renormalized)."""
    if isinstance(n, Phrase):
        budget[0] -= n.size
        return Dummy() if budget[0] < 0 else n
    if isinstance(n, BinOp):
        n.lhs = _trim(n.lhs, budget)
        n.rhs = _trim(n.rhs, budget)
    elif isinstance(n, (UnaryOp, ConstTrueExpr)):
        n.expr = _trim(n.expr, budget)
    elif isinstance(n, MatchSome):
        n.nodes = [_trim(c, budget) for c in n.nodes]
    return n


def _node_count(root: Node) -> int:
    """Iterative node count (recursion-safe on deep operator chains)."""
    n = 0
    stack = [root]
    while stack:
        x = stack.pop()
        n += 1
        if isinstance(x, BinOp):
            stack += (x.lhs, x.rhs)
        elif isinstance(x, (UnaryOp, ConstTrueExpr)):
            stack.append(x.expr)
        elif isinstance(x, MatchSome):
            stack += x.nodes
    return n


def normalize_root(root: Optional[Node]) -> Tuple[Optional[Node], int]:
    """normalize_root (queries.cpp:1251-1348). Returns (root | None, index count)."""
    if root is None:
        return None, 0
    import sys

    # the rewrite passes recurse; giant (post-trim) queries chain thousands
    # of binops deep, so size the Python stack to the tree once up front
    need = _node_count(root) * 4 + 1000
    if sys.getrecursionlimit() < need:
        sys.setrecursionlimit(need)
    ctx = _Ctx()
    while True:
        ctx.updates = 0
        ctx.tokens_cnt = 0
        root = _normalize(root, ctx)
        if not ctx.updates:
            break
    if ctx.tokens_cnt > MAX_QUERY_TOKENS:
        # trim to the cap instead of nullifying (queries.cpp:1503)
        root = _trim(root, [MAX_QUERY_TOKENS])
        while True:
            ctx.updates = 0
            ctx.tokens_cnt = 0
            root = _normalize(root, ctx)
            if not ctx.updates:
                break
    if _is_dummy(root) or _is_false(root):
        return None, 0
    if isinstance(root, UnaryOp):
        if root.op is Op.NOT:
            return None, 0
        if root.op in (Op.OR, Op.AND):
            root = root.expr
    if not has_leader_tokens(root):
        return None, 0
    actx = _AssignCtx()
    _assign_indices(root, actx)
    return root, actx.next_index
