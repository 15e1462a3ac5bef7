# Copy of trinity_tpu/plan/compile.py; only its imports name the port.
"""Query compiler: normalized AST -> hashable device plan.

The analog of the reference's compilation layer (compilation_ctx.cpp):
compile_query lowers the AST to exec_nodes with interned per-execution term
ids (exec_term_id_t, queryexec_ctx.cpp:279-296) and runs
collapse/expand/optimize passes. Here the lowering target is a *tile tape*:
a nested tuple of structural ops over term slots, evaluated as dense tile
algebra by trinity_tpu.exec. The tuple is hashable — it is the jit cache key,
so queries with the same shape share one compiled XLA program and term
ids/weights flow in as data (SURVEY §7 "avoid XLA recompiles").

Plan node forms:
  ("tok", slot, widx)              a single term
  ("phrase", (slot, ...), widx)    ordered adjacent terms
  ("and", l, r) ("or", l, r) ("not", l, r)   binops (NOT = lhs AND NOT rhs)
  ("unot", c)                      unary NOT (matches docs where c fails)
  ("opt", c)                       ConstTrueExpr optional-match
  ("some", min, (c, ...))          MatchSome k-of-n
  ("false",)                       ConstFalse

Most of the reference's exec_node optimizations (collapse_node/expand_node
termruns, compilation_ctx.cpp:332-671) exist to batch iterator work; dense
tile evaluation gets that for free, so only the structural lowering remains.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

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


@dataclass
class CompiledPlan:
    """A lowered query: structure (hashable) + data (term texts, weights)."""

    tape: tuple  # nested plan tuple — jit cache key
    term_texts: List[str]  # slot -> term text
    weight_terms: List[Tuple[str, ...]]  # widx -> member terms (for weights)
    has_phrase: bool = False

    @property
    def n_slots(self) -> int:
        return len(self.term_texts)


class _Builder:
    def __init__(self):
        self.slots: Dict[str, int] = {}
        self.term_texts: List[str] = []
        self.weights: Dict[Tuple[str, ...], int] = {}
        self.weight_terms: List[Tuple[str, ...]] = []
        self.has_phrase = False

    def slot(self, text: str) -> int:
        s = self.slots.get(text)
        if s is None:
            s = len(self.term_texts)
            self.slots[text] = s
            self.term_texts.append(text)
        return s

    def widx(self, terms: Tuple[str, ...]) -> int:
        w = self.weights.get(terms)
        if w is None:
            w = len(self.weight_terms)
            self.weights[terms] = w
            self.weight_terms.append(terms)
        return w

    def lower(self, n: Node) -> tuple:
        if isinstance(n, Phrase):
            texts = tuple(t.text for t in n.terms)
            w = self.widx(texts)
            if n.size == 1:
                return ("tok", self.slot(texts[0]), w)
            self.has_phrase = True
            return ("phrase", tuple(self.slot(t) for t in texts), w)
        if isinstance(n, BinOp):
            op = n.op.normalized()
            l = self.lower(n.lhs)
            r = self.lower(n.rhs)
            return ({Op.AND: "and", Op.OR: "or", Op.NOT: "not"}[op], l, r)
        if isinstance(n, UnaryOp):
            if n.op is Op.NOT:
                return ("unot", self.lower(n.expr))
            return self.lower(n.expr)  # +x / AND x == x here
        if isinstance(n, ConstTrueExpr):
            return ("opt", self.lower(n.expr))
        if isinstance(n, MatchSome):
            return ("some", n.min, tuple(self.lower(c) for c in n.nodes))
        if isinstance(n, (ConstFalse, Dummy)):
            return ("false",)
        raise TypeError(type(n))


def compile_plan(root: Node) -> CompiledPlan:
    b = _Builder()
    tape = b.lower(root)
    return CompiledPlan(
        tape=tape,
        term_texts=b.term_texts,
        weight_terms=b.weight_terms,
        has_phrase=b.has_phrase,
    )
