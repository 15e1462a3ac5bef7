# Copy of trinity_tpu/query/ast.py; only its imports name the port.
"""Query AST.

Mirrors the reference's ast_node model (queries.h:36-97): binary ops
(AND / STRICT_AND / OR / NOT), tokens, phrases (with rep, flags,
app_phrase_id, index/toNextSpan and rewrite_ctx metadata,
queries.h:312-492), unary ops, ConstFalse, ConstTrueExpr (optional-match,
queries.h:onstTrueExpr comment block) and MatchSome (k-of-n,
queries.h:MatchSome comment block). Python dataclasses instead of an
arena-allocated union; the compiler (trinity_tpu.plan) consumes these.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple


class Op(enum.Enum):
    NONE = 0
    AND = 1
    NOT = 2
    OR = 3
    STRICT_AND = 4  # mostly equivalent to AND (queries.h:15)

    def normalized(self) -> "Op":
        return Op.AND if self is Op.STRICT_AND else self


@dataclass
class RewriteCtx:
    """phrase::rewrite_ctx (queries.h:392-438): provenance of rewritten terms."""

    range: Optional[Tuple[int, int]] = None  # [offset, offset+len) in original indices
    translation_coefficient: float = 1.0
    src_seq_size: int = 0


class Node:
    """Base class; subclasses below."""

    __slots__ = ()


@dataclass
class Term:
    """A single query term (queries.h: term). Text kept as str; byte
    comparisons (terms_cmp) applied on the utf-8 encoding."""

    text: str

    def __post_init__(self):
        assert self.text


@dataclass
class Phrase(Node):
    """Token (size==1) and Phrase (size>1) share this payload, like the
    reference's `phrase` struct (queries.h:312-492)."""

    terms: List[Term]
    is_phrase: bool  # a 1-term phrase stays a phrase ("ipad" quoted, queries.h:69-72)
    rep: int = 1  # parse-time dedup: [apple AND apple] -> rep=2 (queries.cpp:509-515)
    flags: int = 0
    app_phrase_id: int = 0
    index: int = 0  # query token index, assigned by normalize
    to_next_span: int = 0
    rewrite_ctx: RewriteCtx = field(default_factory=RewriteCtx)

    @property
    def size(self) -> int:
        return len(self.terms)

    def same(self, other: "Phrase") -> bool:
        return [t.text for t in self.terms] == [t.text for t in other.terms]


def Token(text: str, **kw) -> Phrase:
    """A Token node is a 1-term non-phrase Phrase payload."""
    return Phrase(terms=[Term(text)], is_phrase=False, **kw)


@dataclass
class BinOp(Node):
    op: Op
    lhs: Node
    rhs: Node


@dataclass
class UnaryOp(Node):
    op: Op
    expr: Node


@dataclass
class ConstFalse(Node):
    pass


@dataclass
class Dummy(Node):
    """GC'd by normalize (queries.h:set_dummy)."""


@dataclass
class ConstTrueExpr(Node):
    """Optional-match: always 'true', evaluates expr for match capture
    (queries.h ConstTrueExpr docs)."""

    expr: Node


@dataclass
class MatchSome(Node):
    """k-of-n (queries.h MatchSome): at least ``min`` of ``nodes`` match."""

    nodes: List[Node]
    min: int = 1


def copy_node(n: Node) -> Node:
    """Deep copy (queries.cpp:1352-1462 analog)."""
    if isinstance(n, Phrase):
        return replace(
            n,
            terms=[Term(t.text) for t in n.terms],
            rewrite_ctx=replace(n.rewrite_ctx),
        )
    if isinstance(n, BinOp):
        return BinOp(n.op, copy_node(n.lhs), copy_node(n.rhs))
    if isinstance(n, UnaryOp):
        return UnaryOp(n.op, copy_node(n.expr))
    if isinstance(n, ConstTrueExpr):
        return ConstTrueExpr(copy_node(n.expr))
    if isinstance(n, MatchSome):
        return MatchSome([copy_node(c) for c in n.nodes], n.min)
    if isinstance(n, ConstFalse):
        return ConstFalse()
    if isinstance(n, Dummy):
        return Dummy()
    raise TypeError(type(n))


def node_to_str(n: Node) -> str:
    """Readable form, loosely matching the reference printer (queries.cpp)."""
    if isinstance(n, Phrase):
        body = " ".join(t.text for t in n.terms)
        s = f'"{body}"' if n.is_phrase else body
        if n.rep > 1:
            s += f"(x{n.rep})"
        return s
    if isinstance(n, BinOp):
        op = {Op.AND: " ", Op.STRICT_AND: " AND ", Op.OR: " OR ", Op.NOT: " NOT "}[n.op]
        return f"({node_to_str(n.lhs)}{op}{node_to_str(n.rhs)})"
    if isinstance(n, UnaryOp):
        pfx = {Op.NOT: "-", Op.AND: "+", Op.STRICT_AND: "+"}.get(n.op, "?")
        return pfx + node_to_str(n.expr)
    if isinstance(n, ConstTrueExpr):
        return f"<{node_to_str(n.expr)}>"
    if isinstance(n, MatchSome):
        return (
            f"[{','.join(node_to_str(c) for c in n.nodes)}]/{n.min}"
        )
    if isinstance(n, ConstFalse):
        return "<FALSE>"
    if isinstance(n, Dummy):
        return "<dummy>"
    raise TypeError(type(n))
