"""Default (rich-match) execution mode: matched documents with term hits.

Counterpart of ``trinity_tpu/exec/richmatch.py``. Its host half is a copy
(``AbortSearch`` .. ``_relax_tape``, :31-245, and the bulk
materialization and callback loop of ``exec_rich``, :384-487);
tests/test_torch_host.py holds the copied classes and functions to the
originals by source. The reference's default mode hands the application a
``matched_document`` per match — matched terms, their freqs and
materialized hits (positions + payloads), plus a DocWordsSpace for
proximity tests (matches.h:117-186, queryexec_ctx.cpp:535-648).

The device pass (``rich_pass``, the reference's ``_build_rich_fn``) is
torch over the decode kernel K1: every window's cells decoded with hit
offsets at T = ``_pad_T(n_slots)``; the relaxed plan's match mask from
``eval_tape_tiles`` (phrase -> member conjunction at positive polarity,
const-false at negated polarity, so the candidate set is a superset),
ANDed with the live documents; each window's first C candidates in docid
order by ``compact_mask`` (the reference's ``lax.top_k`` over
``WINDOW_SIZE - iota`` picks the same set in the same order; a
``torch.topk`` would promise no order among ties); each candidate's
per-slot freq and hits offset by ``gather_cols``. C grows as the
reference's does (``rich_candidate_cap``, then 8192, then WINDOW_SIZE)
until it holds every window's count: the mask is computed once, the
counts are read by the host once, and C is picked from them (the reference
reran its whole program for each rung). The candidates then go to the
host, in (window, in-window docid) order, which is global docid order.

Positions are decoded on the host (``utils/bitpack.unpack_value_groups``)
in one vectorized gather, and phrases are re-evaluated exactly on them
with the port's copy of the spec evaluator (``exec/speceval.py``). An
AbortSearch raised by the callback stops enumeration — the
aborted_search_exception analog (matches.h:132-137).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from trinity_tpu_torch.limits import MAX_POSITION, WINDOW_SIZE
from trinity_tpu_torch.ops.select import compact_mask, gather_cols

RICH_MID_CAP = 8192  # the second rung of the reference's candidate ladder


class AbortSearch(Exception):
    """Raise from a match callback to abort (matches.h:132-137)."""


@dataclass
class TermHit:
    """runtime.h:8-20 term_hit: payload value + how many of its 8 bytes
    the application wrote (payloadLen)."""

    pos: int
    payload: int = 0
    payload_len: int = 0

    def payload_bytes(self) -> bytes:
        """The term_hit::bytes() view: the meaningful payload bytes."""
        return int(self.payload).to_bytes(8, "little")[: self.payload_len]


@dataclass
class MatchedTerm:
    """One matched term with materialized hits (matches.h:36-71 term_hits)."""

    term: str
    freq: int
    hits: List[TermHit]


@dataclass(frozen=True)
class QueryIndexTerm:
    """matches.h:17-24 query_index_term: one term that may match at a query
    index, with the span distance to the next AND-sibling group — the
    metadata applications use for sequence/proximity scoring."""

    term: str
    flags: int
    to_next_span: int


@dataclass(frozen=True)
class TermInstance:
    """query_term_ctx::instance_struct (matches.h:86-99): one occurrence of
    a term in the original query, with rewrite provenance."""

    index: int
    rep: int
    flags: int
    to_next_span: int
    app_phrase_id: int
    rewrite_range: tuple  # (start, stop) token range of the rewrite source
    translation_coefficient: float
    src_seq_size: int


@dataclass
class QueryTermCtx:
    """query_term_ctx (matches.h:76-108): all original-query instances of
    one term, sorted by query index."""

    term: str
    instances: List[TermInstance]


def collect_query_index_terms(root, disregard_token_flags: bool = False):
    """Build the proximity-scoring context the reference hands to
    MatchedIndexDocumentsFilter::prepare() (exec.cpp:585-657 instance
    collection + exec.cpp:694-873 per-index dedup):

    Returns (term_ctxs: Dict[term, QueryTermCtx],
             query_index_terms: Dict[index, Tuple[QueryIndexTerm, ...]]).

    Collection walks only positively-reachable nodes (NOT rhs and unary-NOT
    subtrees are skipped); each phrase member i lands at index + i with
    toNextSpan = 1 except the last member, which carries the phrase's span
    distance (exec.cpp:649-655). disregard_token_flags switches the
    per-index dedup key from (term, toNextSpan, flags) to
    (term, toNextSpan) with flags zeroed
    (ExecFlags::DisregardTokenFlagsForQueryIndicesTerms, exec.h:36-42)."""
    from trinity_tpu_torch.query.ast import (
        BinOp,
        ConstTrueExpr,
        MatchSome,
        Op,
        Phrase,
        UnaryOp,
    )

    instances: List[tuple] = []  # (term, TermInstance)
    stack = [root] if root is not None else []
    while stack:
        n = stack.pop()
        if isinstance(n, Phrase):
            rep = n.rep if n.size == 1 else 1
            for i, t in enumerate(n.terms):
                instances.append(
                    (
                        t.text,
                        TermInstance(
                            index=n.index + i,
                            rep=rep,
                            flags=n.flags,
                            to_next_span=(
                                n.to_next_span if i == n.size - 1 else 1
                            ),
                            app_phrase_id=n.app_phrase_id,
                            rewrite_range=n.rewrite_ctx.range,
                            translation_coefficient=(
                                n.rewrite_ctx.translation_coefficient
                            ),
                            src_seq_size=n.rewrite_ctx.src_seq_size,
                        ),
                    )
                )
        elif isinstance(n, MatchSome):
            stack.extend(n.nodes)
        elif isinstance(n, UnaryOp):
            if n.op is not Op.NOT:
                stack.append(n.expr)
        elif isinstance(n, ConstTrueExpr):
            stack.append(n.expr)
        elif isinstance(n, BinOp):
            stack.append(n.lhs)
            if n.op in (Op.AND, Op.STRICT_AND, Op.OR):
                stack.append(n.rhs)

    term_ctxs: Dict[str, QueryTermCtx] = {}
    for term, inst in sorted(
        instances, key=lambda x: (x[0], x[1].index)
    ):
        term_ctxs.setdefault(term, QueryTermCtx(term, [])).instances.append(
            inst
        )

    per_index: Dict[int, list] = {}
    for term, inst in instances:
        flags = 0 if disregard_token_flags else inst.flags
        per_index.setdefault(inst.index, []).append(
            QueryIndexTerm(term, flags, inst.to_next_span)
        )
    query_index_terms = {
        idx: tuple(
            sorted(
                set(lst),
                key=lambda q: (q.term, q.to_next_span, q.flags),
            )
        )
        for idx, lst in per_index.items()
    }
    return term_ctxs, query_index_terms


@dataclass
class MatchedDocument:
    """matches.h:117-130 matched_document. query_index_terms /term_ctxs are
    the shared per-query proximity context (matches.h:27-32) — per query
    index, the unique (term, flags, toNextSpan) triples that may match
    there — so applications can implement the reference's
    sequence/proximity scoring from callback data alone."""

    doc_id: int
    matched_terms: List[MatchedTerm]
    dws: "DocWordsSpace"
    query_index_terms: Dict[int, tuple] = field(default_factory=dict)
    term_ctxs: Dict[str, QueryTermCtx] = field(default_factory=dict)

    def term(self, text: str) -> Optional[MatchedTerm]:
        for mt in self.matched_terms:
            if mt.term == text:
                return mt
        return None


class DocWordsSpace:
    """Positional scratchpad (docwordspace.h:40-127): O(1) set/test of
    (term, position), plus the reference phrase test (docwordspace.cpp:3-15)."""

    def __init__(self, max_pos: int = MAX_POSITION):
        self._pos: Dict[int, str] = {}

    def set(self, term: str, pos: int) -> None:
        self._pos[pos] = term

    def test(self, term: str, pos: int) -> bool:
        return self._pos.get(pos) == term

    def test_phrase(self, terms: List[str], first_pos: int) -> bool:
        return all(
            self.test(t, first_pos + i) for i, t in enumerate(terms)
        )


def _relax_tape(tape, polarity=True):
    """Phrase -> member AND at positive polarity (superset), const-false /
    const-true swaps at negative polarity so the device mask stays a
    superset of the exact matches."""
    kind = tape[0]
    if kind == "phrase":
        _, slots, widx = tape
        if not polarity:
            return ("false",)
        out = ("tok", slots[0], widx)
        for s in slots[1:]:
            out = ("and", out, ("tok", s, widx))
        return out
    if kind in ("and", "or"):
        return (kind, _relax_tape(tape[1], polarity), _relax_tape(tape[2], polarity))
    if kind == "not":
        return ("not", _relax_tape(tape[1], polarity), _relax_tape(tape[2], not polarity))
    if kind == "unot":
        return ("unot", _relax_tape(tape[1], not polarity))
    if kind == "opt":
        # optional-match contributes capture only; keep for slot gathering
        return ("opt", _relax_tape(tape[1], polarity))
    if kind == "some":
        return ("some", tape[1], tuple(_relax_tape(c, polarity) for c in tape[2]))
    return tape


def rich_pass(executor, relaxed_tape, cs: np.ndarray, cn: np.ndarray,
              cap: int):
    """The device pass: K1 with hit offsets over every window of the cells
    (cs, cn: (W, T) i32), the relaxed tape's mask over the live documents,
    the first C candidates of each window in docid order, where C is the
    first rung of (`cap`, 8192, WINDOW_SIZE) that holds every window's
    count. Returns (C, local docids (M,) int64, freqs (M, T) i32, hits
    offsets (M, T) i32) of the M candidates, on the executor's device, in
    docid order."""
    from trinity_tpu_torch.ops.fusedscore import eval_tape_tiles
    from trinity_tpu_torch.ops.postings import materialize_freq_tiles

    W, T = cs.shape
    tiles, offs = materialize_freq_tiles(
        executor.bmeta, executor.planes, executor._put(cs), executor._put(cn),
        with_offsets=True,
    )
    freq = tiles.reshape(W, T, WINDOW_SIZE)
    offv = offs.reshape(W, T, WINDOW_SIZE)
    mask, _ = eval_tape_tiles(
        relaxed_tape, {s: freq[:, s] for s in range(T)}, lambda i: 0.0,
        "trivial",
    )
    mask = mask & executor._live_docs()
    max_cnt = int(mask.sum(dim=1).max()) if W else 0  # a host sync
    C = min(cap, WINDOW_SIZE)
    while max_cnt > C and C < WINDOW_SIZE:
        C = WINDOW_SIZE if max_cnt > RICH_MID_CAP else RICH_MID_CAP
    ki, valid = compact_mask(mask, C)
    pf = torch.stack([gather_cols(freq[:, s], ki) for s in range(T)], -1)
    po = torch.stack([gather_cols(offv[:, s], ki) for s in range(T)], -1)
    vw, vc = torch.nonzero(valid, as_tuple=True)  # row-major: docid order
    local = vw * WINDOW_SIZE + ki[vw, vc].to(torch.int64)
    return C, local, pf[vw, vc].to(torch.int32), po[vw, vc]


def exec_rich(
    executor,
    query,
    on_match: Callable[[MatchedDocument], None],
    candidate_cap: Optional[int] = None,
    disregard_token_flags: bool = False,
    on_prepare: Optional[Callable[[dict], None]] = None,
    doc_filter: Optional[Callable[[int], bool]] = None,
    doc_set=None,
) -> int:
    """Default-mode execution: invokes on_match(MatchedDocument) for every
    matching document in ascending doc order (exec.cpp default mode).
    Returns the number of matches delivered.

    The per-query proximity context (query_index_terms) is built once and
    surfaced both through on_prepare (the MatchedIndexDocumentsFilter::
    prepare() analog, matches.h:139-147) and on every MatchedDocument.
    disregard_token_flags = ExecFlags::DisregardTokenFlagsForQueryIndicesTerms
    (exec.h:36-42): dedup per-index terms by (term, toNextSpan) and zero the
    flags.

    doc_filter(app_docid) -> True to disregard the document BEFORE it is
    materialized/evaluated — the IndexDocumentsFilter pre-veto
    (matches.h:198-201). doc_set: optional app docid array the query is
    ANDed against (VectorIDs, docset_iterators.cpp:415-452); it swaps the
    executor's masks for the call, so it must not run beside another
    thread's search on the same executor (as in the reference).

    On a CUDA executor the device pass launches the decode kernel; on a CPU
    executor it runs the kernel's plain version."""
    if doc_set is not None:
        saved = executor._doc_set_masks(doc_set)
        try:
            return exec_rich(
                executor, query, on_match, candidate_cap,
                disregard_token_flags, on_prepare, doc_filter,
            )
        finally:
            executor._restore_masks(saved)

    from trinity_tpu_torch.config import get_config
    from trinity_tpu_torch.exec.planning import _pad_T
    from trinity_tpu_torch.exec.speceval import Scorer, _eval
    from trinity_tpu_torch.models.similarity import Trivial
    from trinity_tpu_torch.ops.postings import compute_cells
    from trinity_tpu_torch.plan.compile import compile_plan
    from trinity_tpu_torch.query.parser import Query, parse_query
    from trinity_tpu_torch.utils import seal
    from trinity_tpu_torch.utils.bitpack import unpack_value_groups

    if isinstance(query, str):
        query = parse_query(query)
    root = query.root if isinstance(query, Query) else query
    if root is None:
        return 0
    term_ctxs, qit = collect_query_index_terms(root, disregard_token_flags)
    if on_prepare is not None:
        on_prepare(qit)
    seg = executor.seg
    plan = compile_plan(root)
    relaxed = _relax_tape(plan.tape)
    tids = [seg.term_id(t) for t in plan.term_texts]
    cs, cn = compute_cells(seg, tids)
    T = _pad_T(plan.n_slots)
    pad = T - plan.n_slots
    if pad:
        cs = np.pad(cs, ((0, 0), (0, pad)))
        cn = np.pad(cn, ((0, 0), (0, pad)))
    if candidate_cap is None:
        candidate_cap = get_config().rich_candidate_cap
    Tn = plan.n_slots
    C, local, pf, po = rich_pass(executor, relaxed, cs, cn, candidate_cap)
    seal.record(("rich", T, C))
    local = local.cpu().numpy()
    if len(local) == 0:
        return 0
    # host materialization, BULK, as the reference's: every surviving
    # candidate's positions/payloads decode in ONE vectorized gather, and
    # the per-match loop only assembles objects from pre-gathered arrays
    fr = pf[:, :Tn].cpu().numpy().astype(np.int64)  # (M, Tn) freqs
    orv = po[:, :Tn].cpu().numpy().astype(np.int64)  # (M, Tn) offsets
    app = seg.doc_map[local].astype(np.int64)
    if doc_filter is not None:
        # pre-eval veto (matches.h:198-201), BEFORE any materialization
        keep = np.fromiter(
            (not doc_filter(int(a)) for a in app), bool, len(app)
        )
        fr, orv, app = fr[keep], orv[keep], app[keep]
        if len(app) == 0:
            return 0
    fr = fr.ravel()  # (M*Tn,) per-candidate per-slot freqs
    orv = orv.ravel()
    tot = int(fr.sum())
    bounds = np.zeros(len(fr) + 1, np.int64)
    np.cumsum(fr, out=bounds[1:])
    flat_idx = np.repeat(orv, fr) + (
        np.arange(tot, dtype=np.int64) - np.repeat(bounds[:-1], fr)
    )
    allpos = unpack_value_groups(seg.hit_planes, seg.hit_group_off, flat_idx)
    payloads = seg.payloads
    allpay = payloads[flat_idx] if payloads is not None else None

    # exact re-evaluation is only needed when the device mask was RELAXED
    # (phrase -> member conjunction superset); for phrase-free queries the
    # device mask is already exact (engine-vs-oracle parity tests)
    need_exact = plan.has_phrase

    class _NullScorer(Scorer):
        def __init__(self):
            self.model = Trivial

        def weight(self, terms):
            return 0.0

    sc = _NullScorer()
    weights_cache: dict = {}
    delivered = 0
    texts = plan.term_texts
    for m in range(len(app)):
        base = m * Tn
        doc_terms: Dict[str, List[int]] = {}
        slot_of: Dict[str, int] = {}
        for s in range(Tn):
            f = int(fr[base + s])
            if f > 0:
                b0 = int(bounds[base + s])
                doc_terms[texts[s]] = allpos[b0 : b0 + f].tolist()
                slot_of[texts[s]] = base + s
        if need_exact:
            matched, _ = _eval(root, doc_terms, sc, weights_cache)
            if not matched:
                continue  # relaxed candidate failing the exact phrase check
        dws = DocWordsSpace()
        pos_map = dws._pos
        mts = []
        for text, pos_list in doc_terms.items():
            for p in pos_list:
                pos_map[p] = text
            if allpay is not None:
                b0 = int(bounds[slot_of[text]])
                hits = [
                    TermHit(
                        p,
                        int(allpay["val"][b0 + i]),
                        int(allpay["len"][b0 + i]),
                    )
                    for i, p in enumerate(pos_list)
                ]
            else:
                hits = [TermHit(p) for p in pos_list]
            mts.append(
                MatchedTerm(term=text, freq=len(pos_list), hits=hits)
            )
        md = MatchedDocument(
            doc_id=int(app[m]),
            matched_terms=mts,
            dws=dws,
            query_index_terms=qit,
            term_ctxs=term_ctxs,
        )
        try:
            on_match(md)
        except AbortSearch:
            return delivered
        delivered += 1
    return delivered
