"""Phrase verification on the device: exact phrase frequency per candidate.

Counterpart of ``trinity_tpu/exec/phrases.py:verify_phrases_device``. Each
candidate doc carries, per phrase member, its freq and the offset of its
position run in the plane-packed positions stream (the hits-offset tiles of
the decode). A phrase occurs at anchor position p iff member m occurs at
p + m for every m (docwordspace.cpp:3-15); duplicate anchor positions
count once each, as the reference counts them.

The structure is the reference's: member runs decode through whole
128-lane groups (``_decode_groups``, row gathers of ``hit_pw`` and a
bit-field extract), sized by a static per-member cap from the FCAP ladder.
Rungs up to 512 decode the run in one window; higher rungs stream it
through 512-lane windows, for the members (``_member_window_hit``) and
for a high-freq anchor (an outer window loop). Adjacency is an all-pairs
compare of the anchor's lanes against each member's.

What differs in torch: the compare cube (candidates x anchor lanes x
member lanes) is materialised, not fused, so candidates run in chunks
under a byte budget; dead candidates are dropped before any decode (one
host sync for the live count of each slice of LIVE_SLICE candidates,
where the reference skipped dead chunks with ``lax.cond``); and the
window loops run as far as the longest run in the chunk needs (one more
sync), as the reference's data-dependent trip count does.

The host half — ``FCAP_LADDER`` and its helpers, ``collect_phrases``,
``fcap_bucket`` and the numpy verifier ``verify_phrase_candidates`` — is
the port's own copy of the reference's, unchanged.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from trinity_tpu_torch.utils.timings import get_tracer

# ------------------------------------------------------------ host half
# Copied from trinity_tpu/exec/phrases.py.
# Per-member position-count cap ladder for the DEVICE verification path:
# gathers are padded to a bucket so plan shapes share compiled programs.
# Rungs <= 512 decode the whole run in one window (the hot shape); larger
# rungs stream the run through 512-lane windows inside a lax.fori_loop with
# a data-dependent trip count, so stopword-grade members (per-doc freq up to
# the 2^16 builder cap) stay ON DEVICE — the reference materializes hits for
# any freq (lucene_codec.cpp:767-856), and since round 3 so does this path.
FCAP_LADDER = (8, 64, 512, 4096, 65536)
SINGLE_WINDOW_FCAP = 512  # largest rung decoded without the window loop
WINDOW_GROUPS = 4  # groups per window-loop step (512 lanes)
TILE_LANES = 128  # positions-stream group width (plane matrix lane count)


def _lanes_used(fcap: int) -> int:
    """Trimmed decode width for a single-window member run."""
    return -(-(TILE_LANES - 1 + fcap) // 8) * 8


def _win_lanes(fcap: int) -> int:
    """Live lane width of one decode step (memory-budget accounting)."""
    if fcap <= SINGLE_WINDOW_FCAP:
        return _lanes_used(fcap)
    return WINDOW_GROUPS * TILE_LANES


def collect_phrases(tape) -> List[Tuple[tuple, int]]:
    """All ("phrase", slots, widx) nodes in traversal order -> [(slots, widx)]."""
    out: List[Tuple[tuple, int]] = []

    def walk(n):
        kind = n[0]
        if kind == "phrase":
            out.append((n[1], n[2]))
        elif kind in ("and", "or", "not"):
            walk(n[1])
            walk(n[2])
        elif kind in ("unot", "opt"):
            walk(n[1])
        elif kind == "some":
            for c in n[2]:
                walk(c)

    walk(tape)
    return out


def fcap_bucket(max_freq: int) -> int | None:
    """Smallest ladder rung >= max_freq, or None (host fallback)."""
    for b in FCAP_LADDER:
        if max_freq <= b:
            return b
    return None


def _window_count(fcap: int) -> int:
    """Static window-loop trip count covering a full fcap-sized run."""
    ng = (fcap + 126) // 128 + 1
    return -(-ng // WINDOW_GROUPS)


def verify_phrase_candidates(
    positions: np.ndarray,  # u16 positions stream of the segment
    valid: np.ndarray,  # (N,) bool — live candidates
    freqs: np.ndarray,  # (N, K) i32 member freqs
    offs: np.ndarray,  # (N, K) i32 member hits offsets
    chunk: int = 8192,
) -> np.ndarray:
    """Exact phrase frequency per candidate -> (N,) i32.

    A phrase occurs at position p iff member k's positions contain p + k for
    every k (docwordspace.cpp:3-15 test_phrase semantics). Vectorized: pad
    each member's position runs to its max freq, compare all (start, hit)
    pairs, chunked over candidates to bound memory.
    """
    n, k = freqs.shape
    out = np.zeros(n, np.int32)
    if not valid.any():
        return out
    idx = np.flatnonzero(valid)
    for c0 in range(0, len(idx), chunk):
        sel = idx[c0 : c0 + chunk]
        f = freqs[sel]
        o = offs[sel]
        fmax = [int(f[:, m].max(initial=1)) for m in range(k)]
        # padded position matrices per member; padding sentinel never matches
        pos = []
        for m in range(k):
            j = np.arange(fmax[m])
            gather = o[:, m, None] + np.minimum(j[None, :], f[:, m, None] - 1)
            pm = positions[gather].astype(np.int64)
            pm[j[None, :] >= f[:, m, None]] = -(10**6) * (m + 1)
            pos.append(pm)
        start = pos[0]  # (C, F0)
        ok = np.ones(start.shape, bool)
        for m in range(1, k):
            target = start + m  # (C, F0)
            hit = (pos[m][:, None, :] == target[:, :, None]).any(axis=2)
            ok &= hit
        out[sel] = ok.sum(axis=1)
    return out


# ---------------------------------------------------------- device half
_U32 = 0xFFFFFFFF
_WL = WINDOW_GROUPS * TILE_LANES  # lanes per window step
# candidates whose live index one nonzero builds (at most 4 MiB of int64),
# so the index's memory does not grow with how many candidates are live
LIVE_SLICE = 1 << 19


def _decode_groups(hit_pw, hit_off, poc, g_off, ng, lmax):
    """Decode ng consecutive 128-value groups starting g_off groups after
    each run's first group -> (c, min(ng * 128, lmax)) int64 values."""
    G = hit_off.shape[0] - 1
    R = hit_pw.shape[0]
    dev = poc.device
    g0 = torch.clamp((poc >> 7) + g_off, 0, max(0, G - 1))
    gs = torch.clamp(g0[:, None] + torch.arange(ng + 1, device=dev), 0, G)
    offv = hit_off.to(torch.int64)[gs]  # (c, ng + 1)
    p0 = offv[:, :ng]
    b = (offv[:, 1:] - p0)[..., None]
    r0 = torch.clamp(p0 >> 5, 0, R - 1)
    sh = (p0 & 31)[..., None]
    w0 = hit_pw[r0].to(torch.int64) & _U32  # (c, ng, 128) row gathers
    w1 = hit_pw[torch.clamp(r0 + 1, 0, R - 1)].to(torch.int64) & _U32
    hi = torch.where(sh > 0, (w1 << ((32 - sh) & 31)) & _U32, 0)
    vals = ((w0 >> sh) | hi) & ((1 << b) - 1)
    return vals.reshape(len(poc), ng * TILE_LANES)[:, :lmax]


def _member_lanes(hit_pw, hit_off, poc, pfc, fcap):
    """Single-window decode of a member's run (fcap <= 512): values (c, L)
    with lanes outside the run set to -1 (no position is negative)."""
    ng = (fcap + 126) // 128 + 1
    vals = _decode_groups(hit_pw, hit_off, poc, 0, ng, _lanes_used(fcap))
    lane = torch.arange(vals.shape[1], device=vals.device)[None, :]
    lo = (poc & 127)[:, None]
    run = (lane >= lo) & (lane < lo + pfc[:, None])
    return torch.where(run, vals, -1), run


def _n_windows(poc, pfc, fcap):
    """Window steps covering the chunk's longest run (a host sync, counted
    in ``phrase.syncs``)."""
    get_tracer().add("phrase.syncs")
    end = int(((poc & 127) + pfc).max())
    return min(-(-end // _WL), _window_count(fcap))


def _member_window_hit(hit_pw, hit_off, poc, pfc, fcap, tgt):
    """Streamed adjacency test for a high-freq member (fcap > 512): does a
    member position equal tgt, for each tgt lane? (c, L0) bool."""
    lo = (poc & 127)[:, None]
    end = lo + pfc[:, None]
    lane0 = torch.arange(_WL, device=poc.device)[None, :]
    hit = torch.zeros(tgt.shape, dtype=torch.bool, device=tgt.device)
    for w in range(_n_windows(poc, pfc, fcap)):
        vals = _decode_groups(hit_pw, hit_off, poc, w * WINDOW_GROUPS,
                              WINDOW_GROUPS, _WL)
        lane = lane0 + w * _WL
        vals = torch.where((lane >= lo) & (lane < end), vals, -1)
        hit |= (vals[:, None, :] == tgt[:, :, None]).any(dim=2)
    return hit


def _live_chunk(hit_pw, hit_off, pfc, poc, fcaps):
    """Phrase frequency of each candidate of a chunk of live ones: (c,)."""
    k = len(fcaps)
    decoded = {
        m: _member_lanes(hit_pw, hit_off, poc[:, m], pfc[:, m], fcaps[m])[0]
        for m in range(1, k) if fcaps[m] <= SINGLE_WINDOW_FCAP
    }

    def anchor_block(start, ok):
        for m in range(1, k):
            tgt = start + m
            if m in decoded:
                hit = (decoded[m][:, None, :] == tgt[:, :, None]).any(dim=2)
            else:
                hit = _member_window_hit(hit_pw, hit_off, poc[:, m],
                                         pfc[:, m], fcaps[m], tgt)
            ok = ok & hit
        return ok.sum(dim=1)

    if fcaps[0] <= SINGLE_WINDOW_FCAP:
        return anchor_block(*_member_lanes(hit_pw, hit_off, poc[:, 0],
                                           pfc[:, 0], fcaps[0]))
    # high-freq anchor: each anchor position lies in exactly one window, so
    # the per-window counts sum to the anchored phrase frequency
    lo = (poc[:, 0] & 127)[:, None]
    end = lo + pfc[:, 0][:, None]
    lane0 = torch.arange(_WL, device=poc.device)[None, :]
    total = torch.zeros(len(poc), dtype=torch.int64, device=poc.device)
    for w in range(_n_windows(poc[:, 0], pfc[:, 0], fcaps[0])):
        start = _decode_groups(hit_pw, hit_off, poc[:, 0], w * WINDOW_GROUPS,
                               WINDOW_GROUPS, _WL)
        lane = lane0 + w * _WL
        total += anchor_block(start, (lane >= lo) & (lane < end))
    return total


def verify_phrases_device(
    hit_pw: torch.Tensor,  # (R, 128) i32 bit-view of the u32 position planes
    hit_off: torch.Tensor,  # (G + 1,) i32 plane offset per position group
    valid: torch.Tensor,  # bool (...,)
    freqs: torch.Tensor,  # int (..., K) member freqs
    offs: torch.Tensor,  # int (..., K) member hits offsets
    fcaps: Tuple[int, ...],
    bytes_budget: int = 1 << 29,
    vol_budget: int = 1 << 28,
) -> torch.Tensor:
    """Exact phrase frequency per candidate, i32 (...,), 0 where invalid.

    fcaps[m] is a cap from FCAP_LADDER at or above member m's largest freq
    in the segment, so a decode never truncates a run. Live candidates run
    in chunks: bytes_budget bounds the decoded lanes (8 bytes a lane, as
    the reference counts them), vol_budget the elements of one compare cube
    (candidates x anchor lanes x widest member's lanes). Each chunk's
    freqs and offsets widen to int64 as it runs. Tracer counters:
    ``phrase.candidates`` (the live candidates), ``phrase.syncs`` (each
    slice's live count and each window trip count)."""
    lead = valid.shape
    k = freqs.shape[-1]
    if k < 2 or len(fcaps) != k:
        raise ValueError("a phrase has at least 2 members, one fcap each")
    n = valid.numel()
    flat = valid.reshape(n)
    pf2 = freqs.reshape(n, k)
    po2 = offs.reshape(n, k)
    out = torch.zeros(n, dtype=torch.int32, device=valid.device)
    tracer = get_tracer()
    bytes_per = 8 * sum(_win_lanes(f) for f in fcaps)
    vol = _win_lanes(fcaps[0]) * max(_win_lanes(f) for f in fcaps[1:])
    chunk = max(128, min(bytes_budget // bytes_per, vol_budget // vol))
    for s0 in range(0, n, LIVE_SLICE):
        live = torch.nonzero(flat[s0 : s0 + LIVE_SLICE]).reshape(-1).add_(s0)
        tracer.add("phrase.syncs")
        tracer.add("phrase.candidates", len(live))
        for c0 in range(0, len(live), chunk):
            idx = live[c0 : c0 + chunk]
            out[idx] = _live_chunk(hit_pw, hit_off, pf2[idx].to(torch.int64),
                                   po2[idx].to(torch.int64) & _U32,
                                   fcaps).to(torch.int32)
    return out.reshape(lead)
