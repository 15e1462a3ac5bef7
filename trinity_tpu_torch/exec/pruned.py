"""Block-max pruned top-k on one segment (the WAND analog).

Counterpart of the reference's ``Executor.search_pruned`` /
``search_pruned_batch`` (``trinity_tpu/exec/executor.py:1885-2089``), of
its two chunk evaluators ``_build_pruned_batch_fn`` and
``_build_pruned_flat_batch_fn`` (:683-738) and of their shared tail
``_pruned_pack_topk`` / ``deleted_take`` (:648-679). The host loop is the
reference's: queries group by tape shape (flat shapes share a group per
padded T), each query gets a per-window score upper bound
(``_tape_window_bounds``: per-block max freqs, summed in f32 in the
kernels' order, padded by 1 + 6e-7 per slot), a group walks the windows
in ONE order (descending cross-query bound) in chunks of
``chunk_windows``, a query resolves once its k-th score strictly beats
every bound left, resolved queries' cells are zeroed, and the top 2k of
each query are kept. Phrase queries and tapes that match a document
holding none of their terms (``_tape_matches_empty``) run search_batch.
Results equal search_batch's exactly.

A chunk is one decode launch (K1, ``materialize_freq_tiles``) over the
chunk's M gathered windows (``window_base``, ascending) and the group's
B * T cells, then the flat structure (``eval_flat_tiles``) or the tape
(``eval_tape_tiles``) in torch, the segment and deletion masks gathered by
window row, and one flat top-k over (B, M * 16384) that keeps ties
docid-ascending because the windows are. A short last chunk is padded
with its own last window; the duplicate's cells are zeroed, so it decodes
nothing and (its tapes matching no empty document) matches nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from trinity_tpu_torch.config import get_config
from trinity_tpu_torch.exec.planning import (
    SearchResult,
    _flatten_tape,
    _pad_T,
    _pick_bucket,
    _tape_matches_empty,
    _tape_window_bounds,
)
from trinity_tpu_torch.limits import WINDOW_SIZE
from trinity_tpu_torch.models.similarity import SIMILARITIES
from trinity_tpu_torch.ops.fusedscore import (
    NEG_INF,
    eval_flat_tiles,
    eval_tape_tiles,
    topk_lowest_index,
)
from trinity_tpu_torch.ops.postings import materialize_freq_tiles
from trinity_tpu_torch.utils.metrics import get_metrics


@dataclass
class PrunedGroup:
    """Queries of one shape and their host inputs for the chunk loop."""

    key: tuple  # ("flat", T) or the tape
    members: list  # [(query index, CompiledPlan)]
    T: int
    B: int  # batch rows, padded to a batch bucket
    arrays: dict  # Executor._bool_arrays: cs, cn, weights (, flags, kmin)
    ub: np.ndarray  # (B, W) f32 padded window bounds
    order: np.ndarray  # (W,) windows by descending cross-query bound


def plan_pruned(ex, plans, scorer: str, stats=None, df_of=None):
    """Group the plans and build each group's cells, weights and window
    bounds. Returns (groups, indices of the queries that run dense)."""
    seg = ex.seg
    model = SIMILARITIES[scorer]
    docs_cnt, df_of = ex._weighting(stats, df_of)
    keyed: dict = {}
    dense = []
    for qi, plan in enumerate(plans):
        if plan is None:
            continue
        if plan.has_phrase or _tape_matches_empty(plan.tape):
            # no verification here; matches-empty tapes make the presence
            # bound unsound and would match the zeroed duplicate's docs
            dense.append(qi)
            continue
        key = plan.tape
        if _flatten_tape(key, plan.n_slots) is not None:
            key = ("flat", _pad_T(plan.n_slots))  # no slot cap here
        keyed.setdefault(key, []).append((qi, plan))
    buckets = get_config().batch_buckets
    groups = []
    for key, members in keyed.items():
        flat = key[0] == "flat"
        T = key[1] if flat else _pad_T(members[0][1].n_slots)
        B = _pick_bucket(buckets, len(members))
        arrays, _, wrows = ex._bool_arrays(members, T, B, flat, model,
                                           docs_cnt, df_of)
        ub = np.zeros((B, seg.n_windows), np.float32)
        for bi, (_, plan) in enumerate(members):
            # the member's own tape, its f32 weights, f32 sums in the
            # kernels' order; the pad keeps a strict < from resolving a tie
            ub[bi], _ = _tape_window_bounds(
                seg, plan.tape, arrays["cs"], arrays["cn"], wrows[bi], model,
                col=lambda ti, b=bi: b * T + ti,
            )
            ub[bi] *= np.float32(1.0 + 6e-7 * max(1, plan.n_slots))
        order = np.argsort(-ub.max(axis=0), kind="stable").astype(np.int32)
        groups.append(PrunedGroup(key, members, T, B, arrays, ub, order))
    return groups, dense


def chunk_cells(g: PrunedGroup, c0: int, chunk_windows: int,
                resolved: np.ndarray):
    """The chunk starting at position c0 of g.order: (ascending windows
    (M,) i32, cell starts (M, B*T), cell counts (M, B*T)), padded to M =
    chunk_windows with its own last window (cells zeroed) and with the
    resolved queries' cells zeroed."""
    sel = g.order[c0 : c0 + chunk_windows]
    pad = chunk_windows - len(sel)
    # pad with a window of THIS chunk (a window outside it may have been
    # evaluated already); ascending, so flat index order = docid order
    selp = np.sort(np.pad(sel, (0, pad), mode="edge")).astype(np.int32)
    csel = g.arrays["cs"][selp]
    nsel = g.arrays["cn"][selp].copy()
    if pad:
        dup = np.zeros(len(selp), bool)
        dup[1:] = selp[1:] == selp[:-1]
        nsel[dup] = 0  # each duplicated window decodes once
    for bi in np.flatnonzero(resolved):
        nsel[:, bi * g.T : (bi + 1) * g.T] = 0
    return selp, csel, nsel


def eval_chunk(ex, g: PrunedGroup, selp, csel, nsel, k: int, scorer: str):
    """One chunk on the device: K1 over the gathered windows, the group's
    structure, liveness and deletions by window row, a flat top-k.
    Returns host (values (B, k) f32, local docids (B, k) int64)."""
    put = ex._put
    M, B, T = len(selp), g.B, g.T
    wb = put(selp)
    tiles = materialize_freq_tiles(ex.bmeta, ex.planes, put(csel),
                                   put(nsel), wb)
    freq = tiles.reshape(M, B, T, WINDOW_SIZE).transpose(0, 1)
    w = put(g.arrays["weights"])
    if g.key[0] == "flat":
        fl, km = put(g.arrays["flags"]), put(g.arrays["kmin"])
        mask, score = eval_flat_tiles(
            [freq[:, :, t] for t in range(T)], lambda t: fl[:, t, None, None],
            km[:, None, None], lambda t: w[:, t, None, None], scorer, T,
        )
    else:
        mask, score = eval_tape_tiles(
            g.key, {s: freq[:, :, s] for s in range(T)},
            lambda i: w[:, i, None, None], scorer,
        )
    base = wb.long() * WINDOW_SIZE
    gid = base[:, None] + torch.arange(WINDOW_SIZE, device=ex.device)
    live = gid < ex.seg.n_docs
    if ex._deleted is not None:
        # row gathers: a window is one contiguous 16384-doc row
        live &= ~ex._deleted.reshape(-1, WINDOW_SIZE)[wb.long()]
    scores = torch.where(mask & live, score, NEG_INF)  # (B, M, N)
    gv, gidx = topk_lowest_index(scores.reshape(B, -1), k)
    gdoc = base[gidx // WINDOW_SIZE] + gidx % WINDOW_SIZE
    return gv.cpu().numpy(), gdoc.cpu().numpy()


def search_pruned_batch(ex, queries: Sequence, k: int = 10,
                        scorer: str = "bm25", chunk_windows: int = 16,
                        stats=None, df_of=None) -> List[List[SearchResult]]:
    """Pruned top-k of `queries` on executor `ex` (see the module
    docstring); counts ``pruned.rounds`` once per chunk launched."""
    seg = ex.seg
    W = seg.n_windows
    plans = ex._parse(queries)
    groups, dense = plan_pruned(ex, plans, scorer, stats, df_of)
    results: List[Optional[List[SearchResult]]] = [None] * len(plans)
    if dense:
        res = ex.search_batch([queries[qi] for qi in dense], k, scorer,
                              stats, df_of)
        for qi, r in zip(dense, res):
            results[qi] = r
    for g in groups:
        nb = len(g.members)
        acc_v = [np.zeros(0, np.float32) for _ in range(nb)]
        acc_i = [np.zeros(0, np.int64) for _ in range(nb)]
        resolved = np.zeros(g.B, bool)
        resolved[nb:] = True  # padding rows
        for c0 in range(0, W, chunk_windows):
            rest = g.order[c0:]
            for bi in range(nb):
                if resolved[bi] or len(acc_v[bi]) < k:
                    continue
                if g.ub[bi, rest].max(initial=0.0) < acc_v[bi][k - 1]:
                    resolved[bi] = True  # strict: a tie could still win
            if resolved.all():
                break
            selp, csel, nsel = chunk_cells(g, c0, chunk_windows, resolved)
            get_metrics().count("pruned.rounds")
            gv, gi = eval_chunk(ex, g, selp, csel, nsel, k, scorer)
            for bi in np.flatnonzero(~resolved[:nb]):
                keep = gv[bi] > NEG_INF
                v = np.concatenate([acc_v[bi], gv[bi][keep]])
                i = np.concatenate([acc_i[bi], gi[bi][keep]])
                o = np.lexsort((i, -v))[: 2 * k]
                acc_v[bi], acc_i[bi] = v[o], i[o]
        for bi, (qi, _) in enumerate(g.members):
            results[qi] = [SearchResult(int(seg.doc_map[i]), float(v))
                           for v, i in zip(acc_v[bi][:k], acc_i[bi][:k])]
    return [r if r is not None else [] for r in results]
