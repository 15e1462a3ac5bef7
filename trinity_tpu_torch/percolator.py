# Copy of the host half of trinity_tpu/percolator.py (:33-347, :483-492).
"""Percolator: reverse search — match streaming documents against
registered queries.

Counterpart of ``trinity_tpu/percolator.py`` (the reference's
percolator.{h,cpp}: queries are compiled once with percolator-local term
ids and every document is matched against all of them). The host half is
a copy of the original's: the opcodes, ``_lower_rpn`` (a plan tape to a
postfix program in which every opcode moves the stack by a fixed amount),
``_phrase_match``, ``register``, ``_pack`` (the programs packed into one
(queries, slots, 2) array and the unique-phrase table, once per
registration epoch), ``build_incidence`` (the (doc, term) and (doc,
phrase) incidence, vectorized numpy) and ``_static_stack_depth``.

The device half is torch (``eval_programs``): since each opcode's stack
movement is fixed, the stack pointer of every (query, slot) is a host-side
cumulative sum, uploaded once per epoch with the programs
(``stage_programs``). The stack is (depth, queries, docs) int32 on the
percolator's device; each slot reads its operands at sp-1 and sp-2 and
writes one level, by ``gather`` / ``scatter`` on the depth axis, all
queries and documents at once; a push reads one row of the (terms +
phrases, docs) incidence by its push id. The query axis is chunked only
when the stack and its per-slot temporaries would pass
``_CHUNK_BUDGET_BYTES``, at any boundary. The result is (docs, queries)
bool.

``match_stream`` launches batch k's evaluation, builds batch k+1's
incidence on the host, and only then copies batch k's result back. Each
batch evaluates one epoch: the host programs, the unique phrases and
their staged device copy are taken together, before the batch's
incidence is built, so a ``register`` between two batches applies from
the next batch built on, whole.

``Percolator(device="cuda")`` is the default and raises without a card;
``device="cpu"`` runs the same torch code on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trinity_tpu_torch.exec.executor import _resolve_device
from trinity_tpu_torch.plan.compile import compile_plan
from trinity_tpu_torch.query.parser import Query, parse_query

# Copied from trinity_tpu/percolator.py (:33-104).
OP_NOP = 0
OP_PUSH_FALSE = 1
OP_PUSH_TRUE = 2
OP_PUSH_TERM = 3  # (term slot)
OP_PUSH_PHRASE = 4  # (phrase id)
OP_AND = 5
OP_OR = 6
OP_ANDNOT = 7  # lhs NOT rhs
OP_UNOT = 8
OP_OPT = 9  # ConstTrueExpr: pop, push true
OP_ADD = 10  # integer add of top two (MatchSome lowering)
OP_GE = 11  # (min): top = top >= min


def _lower_rpn(tape, code: List[Tuple[int, int]], phrases: List[tuple]):
    """Plan tape -> postfix code with static stack movement per op."""
    kind = tape[0]
    if kind == "tok":
        code.append((OP_PUSH_TERM, tape[1]))
    elif kind == "phrase":
        pid = len(phrases)
        phrases.append(tape[1])
        code.append((OP_PUSH_PHRASE, pid))
    elif kind == "and":
        _lower_rpn(tape[1], code, phrases)
        _lower_rpn(tape[2], code, phrases)
        code.append((OP_AND, 0))
    elif kind == "or":
        _lower_rpn(tape[1], code, phrases)
        _lower_rpn(tape[2], code, phrases)
        code.append((OP_OR, 0))
    elif kind == "not":
        _lower_rpn(tape[1], code, phrases)
        _lower_rpn(tape[2], code, phrases)
        code.append((OP_ANDNOT, 0))
    elif kind == "unot":
        _lower_rpn(tape[1], code, phrases)
        code.append((OP_UNOT, 0))
    elif kind == "opt":
        _lower_rpn(tape[1], code, phrases)
        code.append((OP_OPT, 0))
    elif kind == "some":
        _, kmin, children = tape
        for i, c in enumerate(children):
            _lower_rpn(c, code, phrases)
            # children push 0/1; fold into a running count
            if i > 0:
                code.append((OP_ADD, 0))
        code.append((OP_GE, kmin))
    elif kind == "false":
        code.append((OP_PUSH_FALSE, 0))
    else:
        raise ValueError(kind)


def _phrase_match(token_positions: Dict[str, List[int]], terms: Sequence[str]) -> bool:
    """Default match_phrase: exact adjacency (percolator_document_proxy
    analog; the app can pre-supply richer semantics via incidence rows)."""
    if any(t not in token_positions for t in terms):
        return False
    rest = [set(token_positions[t]) for t in terms[1:]]
    return any(
        all(p + i + 1 in s for i, s in enumerate(rest))
        for p in token_positions[terms[0]]
    )


@dataclass
class _Registered:
    code: List[Tuple[int, int]]
    term_slots: List[int]  # global percolator term ids per plan slot
    phrase_terms: List[Tuple[str, ...]]  # phrase id -> member terms


class Percolator:
    """Register queries once, match documents forever (percolator.h:63-85),
    on `device` ("cuda", the default, or "cpu")."""

    def __init__(self, device="cuda"):
        self.device = _resolve_device(device)
        self._vocab: Dict[str, int] = {}
        self._queries: List[Optional[_Registered]] = []
        self._device_state = None  # invalidated on register
        self._ops_dev = None  # staged device copy of the packed programs

    # ---------------------------------------------------------- register
    def _term_id(self, text: str) -> int:
        tid = self._vocab.get(text)
        if tid is None:
            tid = len(self._vocab)
            self._vocab[text] = tid
        return tid

    def register(self, query) -> int:
        """Compile once; returns query id. Null queries register as
        never-matching (reference: percolator_query on empty query)."""
        if isinstance(query, str):
            query = parse_query(query)
        root = query.root if isinstance(query, Query) else query
        self._device_state = None
        self._ops_dev = None
        qid = len(self._queries)
        if root is None:
            self._queries.append(None)
            return qid
        plan = compile_plan(root)
        code: List[Tuple[int, int]] = []
        phrases: List[tuple] = []
        _lower_rpn(plan.tape, code, phrases)
        # plan slots -> global percolator term ids
        term_slots = [self._term_id(t) for t in plan.term_texts]
        phrase_terms = [
            tuple(plan.term_texts[s] for s in slots) for slots in phrases
        ]
        self._queries.append(_Registered(code, term_slots, phrase_terms))
        return qid

    @property
    def n_queries(self) -> int:
        return len(self._queries)

    # ------------------------------------------------------------- state
    def _pack(self):
        """Pack registered programs into dense arrays for device eval,
        including the unique-phrase table and PUSH_PHRASE arg rewrite —
        computed ONCE per registration epoch, not per match_batch call."""
        if self._device_state is not None:
            return self._device_state
        n = len(self._queries)
        max_ops = max((len(q.code) for q in self._queries if q), default=1)
        ops = np.zeros((n, max_ops, 2), np.int32)
        ph_index: Dict[Tuple[str, ...], int] = {}
        uniq_phrases: List[Tuple[str, ...]] = []
        for qi, q in enumerate(self._queries):
            if q is None:
                ops[qi, 0] = (OP_PUSH_FALSE, 0)
                continue
            for i, (op, arg) in enumerate(q.code):
                if op == OP_PUSH_TERM:
                    arg = q.term_slots[arg]  # global term id
                elif op == OP_PUSH_PHRASE:
                    terms = q.phrase_terms[arg]
                    pid = ph_index.get(terms)
                    if pid is None:
                        pid = len(uniq_phrases)
                        ph_index[terms] = pid
                        uniq_phrases.append(terms)
                    arg = pid
                ops[qi, i] = (op, arg)
        self._device_state = (ops, tuple(uniq_phrases))
        return self._device_state

    # -------------------------------------------------------------- match
    def match(self, tokens: Sequence[str], first_pos: int = 1) -> List[int]:
        """Single document -> sorted matching query ids (pq.match analog,
        percolator.cpp:5-7)."""
        return [
            qid
            for qid, hit in enumerate(self.match_batch([list(tokens)], first_pos)[0])
            if hit
        ]

    def _epoch(self):
        """The current registration epoch, taken whole: (packed programs,
        unique phrases, the programs staged on the device once per
        epoch)."""
        ops, uniq_phrases = self._pack()
        if self._ops_dev is None:
            self._ops_dev = stage_programs(ops, self.device)
        return ops, uniq_phrases, self._ops_dev

    def match_batch(
        self, docs: Sequence[Sequence[str]], first_pos: int = 1
    ) -> np.ndarray:
        """Batch documents x registered queries -> bool (n_docs, n_queries):
        the host incidence (build_incidence), then every program over
        every document on the device (eval_programs)."""
        _, uniq_phrases, staged = self._epoch()
        incidence, ph_inc = self.build_incidence(docs, uniq_phrases, first_pos)
        return finish_eval(launch_eval(staged, incidence, ph_inc))

    def match_stream(self, doc_batches, first_pos: int = 1):
        """Streaming match: yields one (n_docs, n_queries) bool array per
        input batch, in order. Batch k's evaluation is launched, batch
        k+1's incidence is built on the host while the device runs, and
        only then is batch k's result copied back. Each batch evaluates the
        epoch current when its incidence was built."""
        pending = None
        for docs in doc_batches:
            _, uniq_phrases, staged = self._epoch()
            incidence, ph_inc = self.build_incidence(
                docs, uniq_phrases, first_pos)
            if pending is not None:
                yield finish_eval(pending)
            pending = launch_eval(staged, incidence, ph_inc)
        if pending is not None:
            yield finish_eval(pending)

    def build_incidence(
        self, docs, uniq_phrases, first_pos: int = 1
    ) -> tuple:
        """Host incidence construction (shared by match_batch and the perf
        tool's host denominator, tools/measure_percolator.py, so both sides
        are charged the identical preprocessing cost)."""
        n_docs = len(docs)
        n_terms = max(1, len(self._vocab))
        docs = [list(toks) for toks in docs]
        lens = np.array([len(t) for t in docs], np.int64)
        flat = [t for toks in docs for t in toks]
        incidence = np.zeros((n_docs, n_terms), bool)
        ph_inc = np.zeros((n_docs, max(1, len(uniq_phrases))), bool)
        if flat:
            doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
            bounds = np.zeros(n_docs + 1, np.int64)
            np.cumsum(lens, out=bounds[1:])
            pos_of = (
                np.arange(len(flat), dtype=np.int64)
                - np.repeat(bounds[:-1], lens)
                + first_pos
            )
            uniq, inv = np.unique(
                np.asarray(flat, dtype=object), return_inverse=True
            )
            tid_of_uniq = np.array(
                [self._vocab.get(t, -1) for t in uniq.tolist()], np.int64
            )
            tid_of = tid_of_uniq[inv]
            keep = tid_of >= 0
            incidence[doc_of[keep], tid_of[keep]] = True
            if uniq_phrases:
                # packed keys: doc (22 bits) | term (21) | position (21)
                if (
                    n_docs >= (1 << 22)
                    or n_terms >= (1 << 21)
                    or (first_pos + int(lens.max(initial=0))) >= (1 << 21)
                ):
                    raise ValueError(
                        "percolator batch exceeds packed-key bounds "
                        "(docs < 2^22, terms < 2^21, positions < 2^21)"
                    )
                d_k, t_k, p_k = doc_of[keep], tid_of[keep], pos_of[keep]
                keys = np.sort((d_k << 42) | (t_k << 21) | p_k)
                if not len(keys):
                    uniq_phrases = ()
                # Vectorized ACROSS phrases (a per-phrase Python loop was the
                # host bottleneck at predicate-index scale: ~5k unique
                # phrases x searchsorted each = ~1 s/batch at 50k registered
                # queries). One candidate row per (phrase, first-member
                # occurrence), built by grouped-range expansion over the
                # term-sorted occurrence table; then ONE searchsorted probe
                # pass per member index (max phrase length passes total).
                n_ph = len(uniq_phrases)
                if n_ph:
                    maxlen = max(len(t) for t in uniq_phrases)
                    tids_mat = np.full((n_ph, maxlen), -1, np.int64)
                    lens_ph = np.zeros(n_ph, np.int64)
                    for pi, terms in enumerate(uniq_phrases):
                        lens_ph[pi] = len(terms)
                        for i, t in enumerate(terms):
                            tids_mat[pi, i] = self._vocab.get(t, -1)
                    # a member never registered -> phrase can never match
                    valid = (tids_mat >= 0) | (
                        np.arange(maxlen)[None, :] >= lens_ph[:, None]
                    )
                    valid = valid.all(axis=1)
                    order = np.argsort(t_k, kind="stable")
                    t_s, d_s, p_s = t_k[order], d_k[order], p_k[order]
                    first = np.where(valid, tids_mat[:, 0], -1)
                    lo = np.searchsorted(t_s, first, "left")
                    hi = np.searchsorted(t_s, first, "right")
                    cnt = np.where(valid, hi - lo, 0)
                    total = int(cnt.sum())
                    if total:
                        pid_rep = np.repeat(np.arange(n_ph), cnt)
                        starts = np.cumsum(cnt) - cnt
                        occ = (
                            np.arange(total)
                            - np.repeat(starts, cnt)
                            + np.repeat(lo, cnt)
                        )
                        d0, p0 = d_s[occ], p_s[occ]
                        ok = np.ones(total, bool)
                        for i in range(1, maxlen):
                            active = lens_ph[pid_rep] > i
                            pk = p0 + i
                            # probes past the 21-bit position field would
                            # alias into the term bits and could
                            # false-positive against a real key; no true
                            # position lives there (bounds check above)
                            in_field = pk < (1 << 21)
                            tk = (
                                (d0 << 42)
                                | (np.maximum(tids_mat[pid_rep, i], 0) << 21)
                                | np.where(in_field, pk, 0)
                            )
                            idx = np.searchsorted(keys, tk)
                            idx_c = np.minimum(idx, len(keys) - 1)
                            found = in_field & (keys[idx_c] == tk)
                            ok &= np.where(active, found, True)
                        ph_inc[d0[ok], pid_rep[ok]] = True
        return incidence, ph_inc

    def match_ids_for_corpus(self, docs):
        """Convenience for tests: {qid: [doc indices]}."""
        m = self.match_batch(docs)
        return {q: list(np.flatnonzero(m[:, q])) for q in range(m.shape[1])}


# Copied from trinity_tpu/percolator.py (:483-492).
def _static_stack_depth(ops: np.ndarray) -> int:
    """Exact max stack depth across programs — every opcode has static
    stack movement, so this is a host-side prefix-max, not max_ops+1
    (which scaled the vmapped carry as (N, D, max_ops+1))."""
    op = ops[..., 0]
    delta = np.zeros_like(op)
    delta[np.isin(op, (OP_PUSH_FALSE, OP_PUSH_TRUE, OP_PUSH_TERM, OP_PUSH_PHRASE))] = 1
    delta[np.isin(op, (OP_AND, OP_OR, OP_ANDNOT, OP_ADD))] = -1
    # >= 2: the shift-stack step statically reads stack[:, 1] (pop2 ops)
    return max(2, int(np.cumsum(delta, axis=1).max(initial=1)))

# stack movement of each opcode (NOP FALSE TRUE TERM PHRASE AND OR ANDNOT
# UNOT OPT ADD GE): +1 a push, -1 two popped and one pushed, 0 the top
# replaced
_DELTA = np.array([0, 1, 1, 1, 1, -1, -1, -1, 0, 0, -1, 0], np.int64)

# device bytes the stack and one slot's temporaries may take: the query
# axis is chunked past it
_CHUNK_BUDGET_BYTES = 2 << 30
_TEMPS = 6  # (queries, docs) int32 temporaries alive during one slot
_BINARY = {OP_AND, OP_OR, OP_ANDNOT, OP_ADD}
_READS_TOP = _BINARY | {OP_NOP, OP_UNOT, OP_GE}


def stage_programs(ops: np.ndarray, device) -> dict:
    """Packed programs (n_queries, max_ops, 2) -> their device form, once
    per registration epoch: opcode and argument, the stack level each slot
    writes (sp after it, less one) and its two operands' levels (sp before
    it, less one and two; clamped at 0 where unread), and the stack depth.
    The host keeps the opcodes, to skip the opcodes a column lacks."""
    op = ops[..., 0].astype(np.int64)
    sp_after = np.cumsum(_DELTA[op], axis=1)
    sp_before = sp_after - _DELTA[op]
    put = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, np.int64)).to(device)
    return {
        "op": put(op), "arg": put(ops[..., 1]),
        "write": put(np.maximum(sp_after - 1, 0)),
        "top": put(np.maximum(sp_before - 1, 0)),
        "under": put(np.maximum(sp_before - 2, 0)),
        "depth": _static_stack_depth(ops), "op_host": op,
    }


def _level(stack, idx):
    """stack[idx[q], q, :] for every query q: (queries, docs)."""
    n, d = stack.shape[1:]
    return stack.gather(0, idx.view(1, n, 1).expand(1, n, d)).squeeze(0)


def _eval_chunk(st: dict, rows: torch.Tensor, push_id: torch.Tensor,
                lo: int, hi: int) -> torch.Tensor:
    """Programs lo..hi over every document: (hi - lo, docs) bool."""
    n, d = hi - lo, rows.shape[1]
    stack = torch.zeros((st["depth"], n, d), dtype=torch.int32,
                        device=rows.device)
    op_host = st["op_host"][lo:hi]
    for i in range(op_host.shape[1]):
        present = set(np.unique(op_host[:, i]).tolist())
        op = st["op"][lo:hi, i, None]
        # the operands are read only where a present opcode reads them
        t0 = (_level(stack, st["top"][lo:hi, i])
              if present & _READS_TOP else None)
        t1 = (_level(stack, st["under"][lo:hi, i])
              if present & _BINARY else None)
        cands = {}
        for code in present:
            if code == OP_NOP:
                v = t0
            elif code == OP_PUSH_FALSE:
                v = torch.zeros((n, d), dtype=torch.int32, device=rows.device)
            elif code in (OP_PUSH_TRUE, OP_OPT):
                v = torch.ones((n, d), dtype=torch.int32, device=rows.device)
            elif code in (OP_PUSH_TERM, OP_PUSH_PHRASE):
                v = rows.index_select(0, push_id[lo:hi, i])
            elif code == OP_AND:
                v = ((t1 > 0) & (t0 > 0)).int()
            elif code == OP_OR:
                v = ((t1 > 0) | (t0 > 0)).int()
            elif code == OP_ANDNOT:
                v = ((t1 > 0) & (t0 == 0)).int()
            elif code == OP_UNOT:
                v = (t0 == 0).int()
            elif code == OP_ADD:
                v = t1 + t0
            else:  # OP_GE
                v = (t0 >= st["arg"][lo:hi, i, None]).int()
            cands[code] = v
        codes = sorted(cands)
        new = cands[codes[0]]
        for code in codes[1:]:
            new = torch.where(op == code, cands[code], new)
        w = st["write"][lo:hi, i]
        stack.scatter_(0, w.view(1, n, 1).expand(1, n, d), new.unsqueeze(0))
    return stack[0] > 0


def launch_eval(st: dict, incidence: np.ndarray, ph_inc: np.ndarray,
                chunk: Optional[int] = None) -> torch.Tensor:
    """Upload a batch's incidence and evaluate every staged program over
    it, without waiting for the device: (n_docs, n_queries) bool on the
    device. `chunk` queries at a time (default: as many as
    _CHUNK_BUDGET_BYTES allows)."""
    device = st["op"].device
    n_q, n_docs = st["op"].shape[0], incidence.shape[0]
    out = torch.zeros((n_docs, n_q), dtype=torch.bool, device=device)
    if n_q == 0 or n_docs == 0:
        return out
    put = lambda a: (torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                     .to(device, non_blocking=True)
                     if device.type == "cuda" else torch.from_numpy(a))
    # (terms + phrases, docs) rows: a push is one row gather
    rows = torch.cat([put(incidence), put(ph_inc)], dim=1).t().int()
    rows = rows.contiguous()
    n_terms = incidence.shape[1]
    push_id = torch.where(
        st["op"] == OP_PUSH_TERM, st["arg"],
        torch.where(st["op"] == OP_PUSH_PHRASE, st["arg"] + n_terms, 0))
    if chunk is None:
        per_q = 4 * n_docs * (st["depth"] + _TEMPS)
        chunk = max(1, _CHUNK_BUDGET_BYTES // per_q)
    for lo in range(0, n_q, chunk):
        hi = min(n_q, lo + chunk)
        out[:, lo:hi] = _eval_chunk(st, rows, push_id, lo, hi).t()
    return out


def finish_eval(pending: torch.Tensor) -> np.ndarray:
    """Copy a launched evaluation back: (n_docs, n_queries) bool numpy."""
    return pending.cpu().numpy()


def eval_programs(ops: np.ndarray, incidence: np.ndarray, ph_inc: np.ndarray,
                  device="cuda", chunk: Optional[int] = None) -> np.ndarray:
    """Packed programs (n_queries, max_ops, 2) over a (n_docs, n_terms)
    term incidence and a (n_docs, n_phrases) phrase incidence ->
    (n_docs, n_queries) bool, on `device` (the reference's
    _eval_programs)."""
    st = stage_programs(ops, _resolve_device(device))
    return finish_eval(launch_eval(st, incidence, ph_inc, chunk))
