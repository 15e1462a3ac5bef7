# Copy of trinity_tpu/query/__init__.py; only its imports name the port.
"""Query language layer (SURVEY §1 L3): AST, parser, normalizer, rewrites."""

from trinity_tpu_torch.query.ast import (
    BinOp,
    ConstFalse,
    ConstTrueExpr,
    MatchSome,
    Node,
    Op,
    Phrase,
    Token,
    UnaryOp,
)
from trinity_tpu_torch.query.parser import Query, parse_query

__all__ = [
    "Node",
    "Op",
    "BinOp",
    "Token",
    "Phrase",
    "UnaryOp",
    "ConstFalse",
    "ConstTrueExpr",
    "MatchSome",
    "Query",
    "parse_query",
]
