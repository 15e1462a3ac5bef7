# Copy of phrase_freq, Scorer and _eval of trinity_tpu/oracle.py (:74-161).
"""The query spec evaluator over one document's term positions.

Rich-match (``exec/richmatch.py``) runs the device pass on a relaxed plan
(phrase -> member conjunction) and re-evaluates each candidate exactly on
its materialized positions with ``_eval``, as the reference's
``exec_rich`` does through its oracle. The oracle stays the JAX package's
test-only module, so the port keeps its own copy of the three pieces it
needs; tests/test_torch_host.py holds each to the original by source.
``Scorer.__init__`` names the oracle's corpus type only in an annotation:
rich-match subclasses it with a weightless scorer.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

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


def phrase_freq(doc: Dict[str, List[int]], terms: List[str]) -> int:
    """Number of phrase occurrences: positions p with term[k] at p+k for all k
    (docwordspace.cpp:3-15 test_phrase reference impl)."""
    if any(t not in doc for t in terms):
        return 0
    first = doc[terms[0]]
    rest = [set(doc[t]) for t in terms[1:]]
    return sum(1 for p in first if all(p + k + 1 in s for k, s in enumerate(rest)))


class Scorer:
    """Per-(term-or-phrase) weight + per-doc score (similarity.h:22-41),
    delegating the actual formulas to the shared spec in
    trinity_tpu/models/similarity.py so oracle and engine cannot diverge.

    docs_cnt/df_of overrides mirror the reference's convention that field
    statistics and document frequencies are aggregated over *raw* segments,
    ignoring generation masking (similarity.h:209-217 sums
    resolve_term_ctx(term).documents per source as-is)."""

    def __init__(self, corpus: OracleCorpus, model, docs_cnt=None, df_of=None):
        self.corpus = corpus
        self.model = model
        self.docs_cnt = corpus.docs_cnt if docs_cnt is None else docs_cnt
        self.df_of = df_of or corpus.doc_freq

    def weight(self, terms: List[str]) -> float:
        dfs = [self.df_of(t) for t in terms]
        return self.model.weight(dfs, self.docs_cnt)

    def score(self, freq: int, weight: float) -> np.float32:
        return np.float32(self.model.host_score(freq, np.float32(weight)))


def _eval(
    n: Node, doc: Dict[str, List[int]], scorer: Scorer, weights: dict
) -> Tuple[bool, np.float32]:
    """Returns (matched, score). Score contributions only from matching
    subtrees, accumulated left-to-right in f32."""
    z = np.float32(0)
    if isinstance(n, Phrase):
        terms = [t.text for t in n.terms]
        if n.size == 1:
            freq = len(doc.get(terms[0], ()))
        else:
            freq = phrase_freq(doc, terms)
        if freq == 0:
            return False, z
        key = tuple(terms)
        if key not in weights:
            weights[key] = scorer.weight(terms)
        return True, scorer.score(freq, weights[key])
    if isinstance(n, BinOp):
        lm, ls = _eval(n.lhs, doc, scorer, weights)
        rm, rs = _eval(n.rhs, doc, scorer, weights)
        op = n.op.normalized()
        if op is Op.AND:
            return (lm and rm), np.float32(ls + rs) if (lm and rm) else z
        if op is Op.OR:
            if lm or rm:
                return True, np.float32(ls + rs)
            return False, z
        if op is Op.NOT:
            return (lm and not rm), ls if (lm and not rm) else z
        raise ValueError(op)
    if isinstance(n, UnaryOp):
        if n.op is Op.NOT:
            m, _ = _eval(n.expr, doc, scorer, weights)
            return (not m), z
        return _eval(n.expr, doc, scorer, weights)
    if isinstance(n, ConstTrueExpr):
        m, s = _eval(n.expr, doc, scorer, weights)
        return True, s if m else z
    if isinstance(n, MatchSome):
        cnt = 0
        total = z
        for c in n.nodes:
            m, s = _eval(c, doc, scorer, weights)
            if m:
                cnt += 1
                total = np.float32(total + s)
        ok = cnt >= n.min
        return ok, total if ok else z
    if isinstance(n, (ConstFalse,)):
        return False, z
    if isinstance(n, Dummy):
        return False, z
    raise TypeError(type(n))
