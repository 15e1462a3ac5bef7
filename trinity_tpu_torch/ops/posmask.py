"""Per-doc position-presence words, and phrase frequency from them.

Counterpart of ``trinity_tpu/ops/posmask.py``. For each (window, member
term) cell ``materialize_posmask_tiles`` writes PW 32-bit words per doc:

    out[w, m, pw, hi, lo]  bit p set  <=>  the term occurs at position
                                           32 * pw + p in local doc
                                           w * 16384 + hi * 128 + lo

(i32 ``[W, M, PW, 128, 128]``; cells with no blocks, and positions at or
above 32 * PW, leave zeros). ``phrase_freq_from_masks`` then gives every
doc's phrase frequency as popcount(AND over members m of mask_m >> m): bit
p survives iff member m occurs at p + m for every m (the anchored test of
docwordspace.cpp:3-15). It equals the anchored count only where positions
are distinct per (term, doc), which the executor's gate checks.

The CUDA kernel lives in ``csrc/posmask.cu``.

``phrase_score_tiles`` then scores a whole posmask phrase group in one
launch (``csrc/phrasescore.cu``): for each query b of the group and each
doc, the phrase frequency of its K members (words from the posmask call's
output or from the posmask hot cache, as a (B, K) table says), the doc's
liveness (frequency above 0, not deleted), the similarity in the plain
version's f32 order, -inf where nothing matches, and each 1024-doc
sub-block's maximum. The reference ran the same per-query loop inside one
jitted XLA program (``trinity_tpu/exec/executor.py:858
_build_phrase_pos_fused``), which fused it; it had no ``pallas_call`` of
its own. Run eagerly op by op, the loop cost ~20 int64 torch ops a member
query, each streaming the group's words widened to int64. The kernel is
bound by bytes: it reads each (query, member)'s PW words per doc once with
16-byte loads (a member that several queries share comes from L2: the
query is the grid's fastest index) and writes the scores once. A thread
owns 4 docs and streams the words upwards, holding only words pw and
pw + 1 of each member, so any PW fits in registers and K is a template
argument (1..16, MAX_PHRASE_SIZE). ``phrase_score_bytes`` counts what one
call must move.

Source note — what it replaces and what bounds it on the H100:
  replaces ``trinity_tpu/ops/posmask.py:303 materialize_posmask_tiles``
  (Pallas body ``_make_posmask_kernel``). The TPU kernel scattered position
  bits with one-hot MXU matmuls into bf16 byte-plane accumulators, moved
  per-posting run bounds from lanes to sublanes with identity matmuls, and
  fetched each cell's rows with fixed-size DMAs sized by host-computed row
  starts and static buckets (RPOS/GOFF). None of that carries over. On
  Hopper the work is bound by bytes: the PW * 64 KiB of words written per
  cell, then the positions of the cell's postings. So a block owns a range
  of a cell's docs (R * PW words = 32 KiB of shared memory, R = 2048 at
  PW = 3) and builds the range's words there: zeroed, each position's bit
  ORed in with a shared-memory atomicOr, then written to the cell once with
  16-byte stores. The block decodes only the postings blocks that meet its
  range (a block-wide count over their first/last docids), a warp per
  block (``decode.cuh``), and the warp walks the range's position elements
  32 consecutive ones at a time (a broadcast group offset and a coalesced
  row of ``hit_pw``, four batches of loads in flight); each element finds
  its posting by a binary search over the block's run starts, kept in
  shared memory. The kernel writes into a caller's strided destination, so
  the posmask hot cache is filled in place. It reads whole rows and needs
  neither the DMA buckets nor the host row starts, so the executor keeps
  every hot term in the mask cache and never routes a phrase to the lazy
  path for a bucket overflow; both routes are exact, so results are the
  same. ``posmask_bytes`` counts what one call must move.
"""

from __future__ import annotations

import torch

from trinity_tpu_torch.limits import MAX_PHRASE_SIZE, TILE, WINDOW_SIZE
from trinity_tpu_torch.models.similarity import SCORER_CODE, score_tile
from trinity_tpu_torch.ops.fusedscore import NEG_INF, NSUB, SUB_DOCS
from trinity_tpu_torch.ops.postings import (
    _U32,
    _bitfield,
    _check,
    block_bytes,
    decode_cells,
)

POS_GUARD_ROWS = 8  # zero rows after hit_pw: a two-row read stays in bounds
MAX_PW = 64  # words per doc the kernel takes (a block holds >= 128 docs)


def decode_positions(hit_pw, hit_off, e):
    """Values at flat indices `e` (int64) of the plane-packed positions
    stream (utils/bitpack.py pack_value_groups): element e lies in group
    e >> 7, lane e & 127, as the b-bit field at plane offset hit_off[g]
    across two words of that lane. Returns int64."""
    g = e >> 7
    lane = e & 127
    off = hit_off.to(torch.int64)
    p0 = off[g]
    b = off[g + 1] - p0
    row = p0 >> 5
    w0 = hit_pw[row, lane].to(torch.int64) & _U32
    w1 = hit_pw[row + 1, lane].to(torch.int64) & _U32
    return _bitfield(w0, w1, p0 & 31, b)


def materialize_posmask_tiles_ref(bmeta, planes, hit_pw, hit_off, cell_start,
                                  cell_nblocks, pw_words, out=None):
    """Plain torch version of the posmask kernel (same contract as
    materialize_posmask_tiles). Runs on any device."""
    W, M = cell_start.shape
    PW = int(pw_words)
    dev = planes.device
    cell, docs, freq, off, valid = decode_cells(
        bmeta, planes, cell_start, cell_nblocks, with_offsets=True
    )
    local = docs - (cell // M)[:, None] * WINDOW_SIZE
    valid = valid & (local >= 0) & (local < WINDOW_SIZE)
    # one row per in-window posting, then one per position element of its
    # run [off, off + freq)
    target = (cell[:, None] * WINDOW_SIZE + local)[valid]
    f = freq[valid]
    start = (off & _U32)[valid]
    post = torch.repeat_interleave(torch.arange(len(f), device=dev), f)
    e = start[post] + torch.arange(len(post), device=dev) - (
        torch.cumsum(f, 0) - f)[post]
    pos = decode_positions(hit_pw, hit_off, e)
    word = pos >> 5
    keep = word < PW
    # OR, not sum: a (doc, bit) pair counts once however often it occurs
    slot = ((target[post] // WINDOW_SIZE * PW + word) * WINDOW_SIZE
            + target[post] % WINDOW_SIZE)[keep] * 32 + (pos & 31)[keep]
    slot = torch.unique(slot)
    words = torch.zeros(W * M * PW * WINDOW_SIZE, dtype=torch.int64,
                        device=dev)
    words.index_add_(0, slot // 32, torch.ones_like(slot) << (slot % 32))
    words = ((words ^ 0x80000000) - 0x80000000).to(torch.int32)  # u32 bits
    words = words.reshape(W, M, PW, TILE, TILE)
    if out is None:
        return words
    _check_out(out, W, M, PW, dev)
    return out.copy_(words)


def _check_out(out, W, M, PW, dev):
    """A destination: i32 (W, M, PW, 128, 128) on `dev` whose members are
    each contiguous (a slice of a larger cache along its member axis)."""
    if out.dtype != torch.int32 or out.device != dev:
        raise TypeError(f"out: expected int32 on {dev}")
    if tuple(out.shape) != (W, M, PW, TILE, TILE):
        raise ValueError(f"out: shape {tuple(out.shape)}, expected "
                         f"{(W, M, PW, TILE, TILE)}")
    if out.stride()[2:] != (WINDOW_SIZE, TILE, 1):
        raise ValueError("out: each member's words must be contiguous")


def materialize_posmask_tiles(
    bmeta: torch.Tensor,  # (rows, 128) i32 (pack_block_meta)
    planes: torch.Tensor,  # (R_pad, 128) i32 bit-view of u32, padded
    hit_pw: torch.Tensor,  # (R2 + POS_GUARD_ROWS, 128) i32 bit-view of u32
    hit_off: torch.Tensor,  # (G + 1,) i32 plane offset of each position group
    cell_start: torch.Tensor,  # (W, M) i32
    cell_nblocks: torch.Tensor,  # (W, M) i32 (0 = absent)
    pw_words: int,
    out: torch.Tensor = None,  # destination (W, M, PW, 128, 128) i32 view
):
    """Returns i32[W, M, PW, 128, 128] position-presence words (module doc),
    written into `out` when given (any view whose members are each
    contiguous, e.g. ``cache[:, i:i + M]``) and returned.

    On CUDA tensors this launches the posmask kernel (csrc/posmask.cu); on
    CPU tensors it runs materialize_posmask_tiles_ref."""
    if planes.device.type != "cuda":
        return materialize_posmask_tiles_ref(
            bmeta, planes, hit_pw, hit_off, cell_start, cell_nblocks,
            pw_words, out,
        )
    from trinity_tpu_torch.utils import kernels

    dev = planes.device
    W, M = cell_start.shape
    PW = int(pw_words)
    for t, name in ((bmeta, "bmeta"), (planes, "planes"), (hit_pw, "hit_pw"),
                    (hit_off, "hit_off"), (cell_start, "cell_start"),
                    (cell_nblocks, "cell_nblocks")):
        _check(t, name, torch.int32, dev)
    if any(t.dim() != 2 or t.shape[1] != TILE
           for t in (bmeta, planes, hit_pw)):
        raise ValueError("bmeta, planes and hit_pw must be (rows, 128)")
    if hit_off.dim() != 1 or cell_nblocks.shape != (W, M):
        raise ValueError("hit_off must be 1-D, cell tables (W, M)")
    if not 1 <= PW <= MAX_PW:
        raise ValueError(f"pw_words must be in [1, {MAX_PW}]")
    if out is None:
        out = torch.empty((W, M, PW, TILE, TILE), dtype=torch.int32,
                          device=dev)
    _check_out(out, W, M, PW, dev)
    if out.data_ptr() % 16:
        raise ValueError("out: must be 16-byte aligned")
    if W * M:
        kernels.launch(
            "posmask", "trin_posmask_tiles",
            bmeta, planes, hit_pw, hit_off, cell_start, cell_nblocks,
            W, M, PW, out, out.stride(0), out.stride(1),
        )
    return out


def posmask_bytes(bmeta, planes, hit_off, cell_start, cell_nblocks,
                  pw_words) -> int:
    """Bytes one materialize_posmask_tiles call must move: the words
    written once (W * M * PW * 64 KiB), the cell tables, each distinct
    postings block's metadata row and plane bits, and each distinct
    positions group that holds a position of an in-window posting (its
    128 b-bit fields and its offset)."""
    W, M = cell_start.shape
    cell, docs, freq, off, valid = decode_cells(
        bmeta, planes, cell_start, cell_nblocks, with_offsets=True
    )
    local = docs - (cell // M)[:, None] * WINDOW_SIZE
    valid = valid & (local >= 0) & (local < WINDOW_SIZE)
    e0 = (off & _U32)[valid]
    e1 = e0 + freq[valid]  # runs [e0, e1), e1 > e0
    off64 = hit_off.to(torch.int64)
    G = len(off64) - 1
    # groups touched: a +1 / -1 difference array over [e0 >> 7, e1-1 >> 7]
    mark = torch.zeros(G + 1, dtype=torch.int64, device=off64.device)
    mark.index_add_(0, e0 >> 7, torch.ones_like(e0))
    mark.index_add_(0, ((e1 - 1) >> 7) + 1, -torch.ones_like(e0))
    used = torch.cumsum(mark, 0)[:G] > 0
    bits = (off64[1:] - off64[:-1])[used]
    return (W * M * int(pw_words) * WINDOW_SIZE * 4 + 2 * W * M * 4
            + block_bytes(bmeta, cell_start, cell_nblocks)
            + int(bits.sum()) * TILE // 8 + 4 * int(used.sum()))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each u32 value held in an int64 tensor (SWAR: torch has
    no popcount). Returns int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _U32) >> 24


def phrase_freq_from_masks(masks, k_members: int, pw_words: int):
    """popcount(AND over members m of (mask_m >> m)) per doc.

    masks: i32 [K, W, PW, 128, 128] member-major (or a sequence of K
    [W, PW, 128, 128] tensors; a repeated member may pass one tensor
    twice). The shift by m runs logically across the PW word axis (bits
    move from word pw + 1 into word pw). Returns i32 [W, 128, 128]."""
    acc = None
    for m in range(k_members):
        wm = masks[m].to(torch.int64) & _U32  # u32 words: >> is logical
        if m:
            nxt = torch.zeros_like(wm)
            nxt[:, : pw_words - 1] = wm[:, 1:]
            wm = (wm >> m) | ((nxt << (32 - m)) & _U32)
        acc = wm if acc is None else acc & wm
    return popcount32(acc).sum(dim=1).to(torch.int32)


def phrase_score_tiles_ref(masks, cache, members, weights, deleted, *,
                           scorer_name):
    """Plain torch version of the phrase score kernel (same contract as
    phrase_score_tiles): the executor's per-query loop, one
    phrase_freq_from_masks a member query."""
    B, K = members.shape
    src = masks if masks is not None else cache
    W, PW = src.shape[0], src.shape[2]
    member = lambda v: masks[:, v] if v >= 0 else cache[:, -1 - v]
    scores = torch.empty((B, W, TILE, TILE), device=src.device)
    for b, row in enumerate(members.tolist()):
        freq = phrase_freq_from_masks([member(v) for v in row], K, PW)
        live = freq > 0
        if deleted is not None:
            live &= deleted == 0
        sc = score_tile(scorer_name, freq.to(torch.float32), weights[b])
        scores[b] = torch.where(live, sc, NEG_INF)
    rmax = scores.reshape(B, W, NSUB, SUB_DOCS).amax(dim=3)
    return scores, rmax


def _check_phrase_args(masks, cache, members, weights, deleted):
    """The group's shapes (W, PW, B, K); raises on a bad dtype, device,
    shape, member count, word count or alignment."""
    src = masks if masks is not None else cache
    if src is None:
        raise ValueError("phrase_score_tiles needs masks or a cache")
    dev = src.device
    W, PW = src.shape[0], src.shape[2]
    for t, name in ((masks, "masks"), (cache, "cache")):
        if t is None:
            continue
        _check(t, name, torch.int32, dev)
        if t.dim() != 5 or t.shape[3:] != (TILE, TILE):
            raise ValueError(f"{name} must be (W, columns, PW, 128, 128)")
        if t.shape[0] != W or t.shape[2] != PW:
            raise ValueError("masks and cache must agree on W and PW")
    _check(members, "members", torch.int32, dev)
    _check(weights, "weights", torch.float32, dev)
    if members.dim() != 2:
        raise ValueError("members must be (B, K)")
    B, K = members.shape
    if weights.shape != (B,):
        raise ValueError("weights must be (B,)")
    if not 1 <= K <= MAX_PHRASE_SIZE:
        raise ValueError(f"a phrase has 1..{MAX_PHRASE_SIZE} members")
    if not 1 <= PW <= MAX_PW:
        raise ValueError(f"pw_words must be in [1, {MAX_PW}]")
    if deleted is not None:
        _check(deleted, "deleted", torch.float32, dev)
        if deleted.shape != (W, TILE, TILE):
            raise ValueError("deleted must be (W, 128, 128)")
    for t, name in ((masks, "masks"), (cache, "cache"), (deleted, "deleted")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    return W, PW, B, K


def phrase_score_tiles(
    masks,  # (W, M, PW, 128, 128) i32 words of the posmask call, or None
    cache,  # (W, C, PW, 128, 128) i32 posmask hot cache, or None
    members,  # (B, K) i32: v >= 0 column v of masks, v < 0 row -1 - v of cache
    weights,  # (B,) f32 phrase weight of each query
    deleted,  # (W, 128, 128) f32 (1.0 = masked) or None
    *,
    scorer_name: str,
):
    """A posmask phrase group's scores: (B, W, 128, 128) f32, -inf where
    query b's phrase does not occur in a live doc, and the sub-block maxima
    (B, W, 16) f32 (module doc). Every tensor contiguous; the word tensors
    and `deleted` 16-byte aligned. The kernel trusts `members` to name
    existing columns and rows: checking them would wait for the card.

    On CUDA tensors this launches the phrase score kernel
    (csrc/phrasescore.cu); on CPU tensors it runs phrase_score_tiles_ref."""
    W, PW, B, K = _check_phrase_args(masks, cache, members, weights, deleted)
    dev = members.device
    if dev.type != "cuda":
        return phrase_score_tiles_ref(masks, cache, members, weights, deleted,
                                      scorer_name=scorer_name)
    from trinity_tpu_torch.utils import kernels

    scores = torch.empty((B, W, TILE, TILE), dtype=torch.float32, device=dev)
    rmax = torch.empty((B, W, NSUB), dtype=torch.float32, device=dev)
    if B * W:
        kernels.launch(
            "phrase", "trin_phrase_score",
            masks, cache, members, weights, deleted, W, B, K,
            0 if masks is None else masks.shape[1],
            0 if cache is None else cache.shape[1], PW,
            SCORER_CODE[scorer_name], scores, rmax,
        )
    return scores, rmax


def phrase_score_bytes(masks, cache, members, deleted) -> int:
    """Bytes one phrase_score_tiles call must move: each distinct member
    column's words read once (W * PW * 64 KiB), the scores and sub-block
    maxima written once (B * W * (64 KiB + 64 B)), the members table, the
    weights and the deletion tiles. A member that several queries share
    counts once (the kernel reads it again from L2)."""
    B, K = members.shape
    src = masks if masks is not None else cache
    W, PW = src.shape[0], src.shape[2]
    distinct = len(torch.unique(members))
    return (distinct * W * PW * WINDOW_SIZE * 4
            + B * W * (WINDOW_SIZE + NSUB) * 4 + B * K * 4 + B * 4
            + (0 if deleted is None else W * WINDOW_SIZE * 4))
