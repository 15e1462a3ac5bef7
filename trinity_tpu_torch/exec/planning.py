"""Host planning helpers of the executor: the port's own copies.

Copied from ``trinity_tpu/exec/executor.py`` (``SearchResult`` :96,
``_phrase_c_bound`` :49, ``_phrase_c_bucket`` :65, ``_pad_T`` :72,
``_plan_for_text`` :118, ``_flatten_tape`` :251, ``_pick_c2`` :1212,
``_phrase_group_c2`` :1238, ``_pick_bucket`` :1254, ``ExecFlags`` :83,
and the pruned search's ``_tape_matches_empty`` :542 and
``_tape_window_bounds`` :571), whose module imports JAX programs around
them; only the imports name the port. The batch
grouping, bucket ladders and phrase candidate capacities are the
reference's, so both executors form the same groups from the same queries.
"""

from __future__ import annotations

import enum
import functools
from dataclasses import dataclass

import numpy as np

from trinity_tpu_torch.limits import WINDOW_SIZE
from trinity_tpu_torch.plan.compile import compile_plan
from trinity_tpu_torch.query.parser import parse_query


# Candidate-capacity ladder for fused phrase programs: C is chosen from the
# per-window candidate BOUND (min member blocks * BLOCK_SIZE, known on host
# from the cell tables), so pass A can never overflow and the program runs
# without any host sync. Bucketing bounds compile variants per tape shape.
PHRASE_C_LADDER = (128, 512, 2048, 8192, 16384)


def _phrase_c_bound(cn_h, phrase_slots, col=None):
    """Upper bound on per-window phrase candidates from block counts.
    cn_h: (W, T*) host block-count table; col maps a slot to its column."""
    from trinity_tpu_torch.limits import BLOCK_SIZE

    if col is None:
        col = lambda s: s
    bound = 0
    for slots in phrase_slots:
        per_w = np.min(
            np.stack([cn_h[:, col(s)] for s in slots]), axis=0
        ) * BLOCK_SIZE
        bound = max(bound, int(per_w.max(initial=0)))
    return min(bound, WINDOW_SIZE)


def _phrase_c_bucket(bound):
    for b in PHRASE_C_LADDER:
        if bound <= b:
            return min(b, WINDOW_SIZE)
    return WINDOW_SIZE


def _pad_T(t: int) -> int:
    """Pad the term axis to a bucket: the Pallas kernel is compiled per
    (W, n_terms), so bucketing bounds kernel variants across query shapes."""
    from trinity_tpu_torch.config import get_config

    for b in get_config().term_buckets:
        if t <= b:
            return b
    return t


class ExecFlags(enum.IntFlag):
    """exec.h:11-43. DOCUMENTS_ONLY = match_ids(); ACCUMULATED_SCORE_SCHEME
    = search(); DISREGARD_TOKEN_FLAGS switches the rich-match
    query_index_terms dedup key (exec_rich(disregard_token_flags=True),
    exec/richmatch.py:collect_query_index_terms)."""

    NONE = 0
    DOCUMENTS_ONLY = 1
    ACCUMULATED_SCORE_SCHEME = 2
    DISREGARD_TOKEN_FLAGS = 4


@dataclass
class SearchResult:
    doc_id: int  # application doc id (translated via doc_map)
    score: float


@functools.lru_cache(maxsize=8192)
def _plan_for_text(qtext: str):
    """Parse + normalize + compile, cached by query text. The reference
    re-parses per call because C++ parsing is ~microseconds
    (exec.cpp:529-539); Python parsing measures ~175 us/query, so repeated
    query texts (hot queries in serving) hit this cache instead. The
    returned root/plan are treated as immutable by all engine paths."""
    q = parse_query(qtext)
    if q.root is None:
        return None, None
    return q.root, compile_plan(q.root)


_FLAG_REQ, _FLAG_NEG, _FLAG_OPT = 1, 2, 4


class _NotFlat(Exception):
    pass


@functools.lru_cache(maxsize=8192)
def _flatten_tape(tape, n_slots):
    """Flatten a boolean tape into (per-slot flags, per-slot widx, kmin),
    or None when the shape can't be expressed flat.

    Accepted shapes: left-leaning AND/NOT chains whose items are tokens,
    opt(token), unot(token|or-chain) or not-with-token/or-chain rhs;
    top-level OR chains of tokens; MatchSome over tokens. The grouping
    restriction (left-leaning, right children contribute <= 1 scored leaf)
    guarantees the kernel's slot-order f32 accumulation is bit-identical
    to _eval_tape's tree-order accumulation — absent/unscored slots add
    +0.0, exact for the non-negative scores. Rejected shapes (nested
    OR-of-AND, slot reuse, phrase) keep their per-tape programs."""
    flags: dict = {}
    widxs: dict = {}
    scored_order: list = []

    def add(slot, bit, widx=None):
        if slot in flags:
            raise _NotFlat  # slot reuse (e.g. rep-dedup kept both tokens)
        flags[slot] = bit
        if widx is not None:
            widxs[slot] = widx
            scored_order.append(slot)

    def negs(t):
        # a pure negation operand: token or OR-chain (¬(a∨b) = ¬a ∧ ¬b)
        if t[0] == "tok":
            add(t[1], _FLAG_NEG)
        elif t[0] == "or":
            negs(t[1])
            negs(t[2])
        else:
            raise _NotFlat

    def item(t):
        # a conjunction item contributing <= 1 scored leaf (so tree
        # grouping == left-assoc accumulation)
        k = t[0]
        if k == "tok":
            add(t[1], _FLAG_REQ, t[2])
        elif k == "opt":
            c = t[1]
            if c[0] != "tok":
                raise _NotFlat
            add(c[1], _FLAG_OPT, c[2])
        elif k == "unot":
            negs(t[1])
        elif k == "not":
            item(t[1])
            negs(t[2])
        else:
            raise _NotFlat

    def conj(t):
        k = t[0]
        if k == "and":
            conj(t[1])
            item(t[2])
        elif k == "not":
            conj(t[1])
            negs(t[2])
        else:
            item(t)

    try:
        k0 = tape[0]
        if k0 == "or":

            def orchain(t):
                if t[0] == "or":
                    orchain(t[1])
                    if t[2][0] != "tok":
                        raise _NotFlat
                    add(t[2][1], _FLAG_REQ, t[2][2])
                elif t[0] == "tok":
                    add(t[1], _FLAG_REQ, t[2])
                else:
                    raise _NotFlat

            orchain(tape)
            kmin = 1
        elif k0 == "some":
            _, kmin, children = tape
            for c in children:
                if c[0] != "tok":
                    raise _NotFlat
                add(c[1], _FLAG_REQ, c[2])
        elif k0 in ("and", "not", "tok", "opt", "unot"):
            conj(tape)
            kmin = sum(1 for b in flags.values() if b == _FLAG_REQ)
        else:
            return None
    except _NotFlat:
        return None
    # slot-order accumulation must equal tree leaf order (slots are
    # assigned at first use in traversal order, so this holds unless a
    # widx remap reordered them — check anyway)
    if scored_order != sorted(scored_order):
        return None
    if any(s >= n_slots for s in flags):
        return None
    return (
        tuple(flags.get(s, 0) for s in range(n_slots)),
        tuple(widxs.get(s, -1) for s in range(n_slots)),
        kmin,
    )


def _pick_c2(total_bound: int, c2_cap: int, k: int) -> int:
    """Smallest lazy-phrase candidate-capacity bucket covering the group's
    largest min-member df (and k) — shared by the single-chip and mesh
    lazyph preps so both compile the same variant ladder (warmup coverage
    keys on C2).

    Above the configured cap the ladder KEEPS GROWING (sparse power-of-4
    rungs) instead of conceding to overflow: a C2 >= min-member-df makes
    overflow impossible, so stopword bigrams stay on the lazy path — the
    flat device verify scales near-linearly with C2 (bytes/vol-bounded
    auto-chunking, exec/phrases.py), while the dense positional fallback
    they previously triggered measured 100-277 ms/query (r4)."""
    from trinity_tpu_torch.config import get_config

    for c2b in (256, 512, 1024, 2048, 4096):
        if total_bound <= c2b <= c2_cap and k <= c2b:
            return c2b
    if total_bound <= c2_cap:
        return c2_cap
    c2_max = get_config().phrase_lazy_max_candidates
    c2b = max(4 * c2_cap, 256)
    while c2b < total_bound and c2b * 4 <= max(c2_max, c2_cap):
        c2b *= 4
    return min(c2b, max(c2_max, c2_cap))


def _phrase_group_c2(df_of, plan, slots, k) -> int:
    """Per-QUERY lazy-phrase C2 bucket, used as part of the batch group
    key: the verify stage costs C2 x a fixed per-candidate DMA (~3.3 us),
    so grouping a rare bigram with a stopword bigram at the group-max C2
    multiplied the whole batch's phrase cost (measured r4: one min-df-445k
    phrase dragged 11 cheap phrases to C2=8192 -> 27 ms EACH). Same-bucket
    queries still share one program variant. Shared by the single-chip and
    mesh preps (bucket drift would hollow out warmup coverage)."""
    from trinity_tpu_torch.config import get_config

    dfs = [int(df_of(plan.term_texts[s])) for s in slots]
    return _pick_c2(
        min(dfs) if dfs else 0, get_config().phrase_lazy_candidates, k
    )


def _pick_bucket(buckets, n: int) -> int:
    """Smallest batch bucket >= n, or n itself above the ladder — ONE
    policy for every grouped program (dense/flat/phrase/pruned, single-chip
    and mesh): bucket drift between prep paths would compile distinct
    variants for the same workload and hollow out warmup coverage."""
    return next((b for b in buckets if b >= n), n)


def _tape_matches_empty(tape) -> bool:
    """True when the tape matches a document containing NONE of its terms
    (all-optional roots, pure negation, MatchSome with kmin=0, ...).

    Such queries match docs in windows where no query term is present, so
    the presence half of the WAND bound is unsound for them, and the
    pruned chunk evaluators' zeroed-cell trick (padding-duplicate window
    neutralization) would turn dead rows into score-0 matches. The pruned
    path routes them to the dense batch — they have nothing to prune
    anyway (every window contains matches)."""
    kind = tape[0]
    if kind in ("tok", "phrase", "false"):
        return False
    if kind == "and":
        return _tape_matches_empty(tape[1]) and _tape_matches_empty(tape[2])
    if kind == "or":
        return _tape_matches_empty(tape[1]) or _tape_matches_empty(tape[2])
    if kind == "not":
        return _tape_matches_empty(tape[1]) and not _tape_matches_empty(tape[2])
    if kind == "unot":
        return not _tape_matches_empty(tape[1])
    if kind == "opt":
        return True
    if kind == "some":
        _, kmin, children = tape
        return sum(_tape_matches_empty(c) for c in children) >= kmin
    return True  # unknown node: conservative — keep it on the dense path


def _tape_window_bounds(seg, tape, cs_h, cn_h, w_h, model, col):
    """Per-window (score upper bound, presence) for ANY boolean tape — the
    generalized WAND bound (docset_iterators.h:38-60), round 3 extension of
    the flat-AND/OR-only bound: token bounds come from per-block max
    frequencies; AND/OR sum child bounds under joint/either presence (each
    child's contribution is zeroed when it can't match); NOT keeps the lhs
    bound (the rhs only removes matches); MatchSome sums member bounds
    under a k-of-n presence count; ConstTrueExpr and unary-NOT can match
    anywhere with zero own contribution. Scores are non-negative (BM25/
    TF-IDF/Trivial weights >= 0), so summed child bounds are sound.

    All sums are f32 in the SAME tree order as the kernel's accumulation
    (_eval_tape / eval_flat_tiles slot order): f32 addition is monotone,
    and each leaf bound >= the leaf's f32 doc score, so every f32 partial
    sum — and hence the final bound — is >= any achievable f32 doc score.
    An f64 bound sum can round BELOW the kernel's rounded-up f32 score and
    wrongfully early-resolve a tie. Over-inclusive at window boundaries —
    safe for an upper bound. Phrase tapes and matches-empty tapes are
    excluded by the caller (no verification machinery; unsound presence)."""
    W = cs_h.shape[0]
    kind = tape[0]
    if kind == "tok":
        _, ti, widx = tape
        c = col(ti)
        starts = cs_h[:, c]
        counts = cn_h[:, c]
        has = counts > 0
        ub = np.zeros(W, np.float32)
        if has.any():
            mf = np.zeros(W, np.int64)
            idx = np.flatnonzero(has)
            red = np.maximum.reduceat(
                np.asarray(seg.block_max_freq, np.int64), starts[idx]
            )
            # reduceat segments run to the next start; also include the last
            # block of each cell (cells can overlap at window boundaries)
            mf[idx] = np.maximum(
                red[: len(idx)],
                seg.block_max_freq[starts[idx] + counts[idx] - 1],
            )
            ub = np.where(
                has,
                np.asarray(
                    model.score_tile(mf.astype(np.float32), w_h[widx]),
                    np.float32,
                ),
                np.float32(0.0),
            )
        return ub, has
    if kind in ("and", "or"):
        lu, lp = _tape_window_bounds(seg, tape[1], cs_h, cn_h, w_h, model, col)
        ru, rp = _tape_window_bounds(seg, tape[2], cs_h, cn_h, w_h, model, col)
        present = (lp & rp) if kind == "and" else (lp | rp)
        return np.where(present, lu + ru, np.float32(0.0)), present
    if kind == "not":
        lu, lp = _tape_window_bounds(seg, tape[1], cs_h, cn_h, w_h, model, col)
        return lu, lp
    if kind == "unot":
        return np.zeros(W, np.float32), np.ones(W, bool)
    if kind == "opt":
        cu, cp = _tape_window_bounds(seg, tape[1], cs_h, cn_h, w_h, model, col)
        return np.where(cp, cu, np.float32(0.0)), np.ones(W, bool)
    if kind == "some":
        _, kmin, children = tape
        tot = np.zeros(W, np.float32)
        cnt = np.zeros(W, np.int64)
        for ch in children:
            cu, cp = _tape_window_bounds(seg, ch, cs_h, cn_h, w_h, model, col)
            tot += cu
            cnt += cp
        present = cnt >= kmin
        return np.where(present, tot, np.float32(0.0)), present
    if kind == "false":
        return np.zeros(W, np.float32), np.zeros(W, bool)
    raise ValueError(kind)
