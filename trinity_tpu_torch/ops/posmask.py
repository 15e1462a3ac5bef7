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

from trinity_tpu_torch.limits import TILE, WINDOW_SIZE
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
