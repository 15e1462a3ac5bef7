"""Decode of bit-plane postings into dense per-(window, term) frequency tiles.

Counterpart of ``trinity_tpu/ops/postings.py:materialize_freq_tiles``. For
each (window, term) cell it decodes the cell's postings blocks and writes a
docid-major (128, 128) tile: ``tile[h, l]`` is the frequency of local doc
``w * 16384 + h * 128 + l`` (0 = absent). ``with_offsets`` adds each
posting's offset into the positions stream (block ``C_HITS`` plus the
exclusive prefix sum of the block's freqs).

The CUDA kernel lives in ``csrc/postings.cu`` (decode routine shared with
the fused score kernels in ``csrc/decode.cuh``).

Source note — what it replaces and what bounds it on the H100:
  replaces ``trinity_tpu/ops/postings.py:530 materialize_freq_tiles``
  (Pallas body ``_make_kernel``/``_decode_groups``). The TPU kernel
  scattered with one-hot MXU matmuls over bf16 byte planes and summed
  deltas with lane rolls, behind double-buffered DMA banks. On the H100
  the call is bound by bytes: each 64 KiB tile written once (twice that
  with offsets), against ~1.5 KiB of planes read per 128-posting block.
  A warp decodes one block: each thread takes 4 lanes of the block's 3
  plane rows as 16-byte words, extracts the two bit-fields, and a 32-wide
  shuffle scan turns deltas into docids. A thread block owns a 2048-doc
  range of one cell (8 per cell, so a 512-cell call is 4096 blocks) and
  builds the range's freqs (and offsets) in shared memory, zeroed first:
  its threads load the cell's metadata rows, a row a thread, into shared
  memory; two block-wide counts over their first/last docids give the
  rows that meet the range (at most 18: a block holds 128 distinct docs);
  the span of plane rows those blocks use (a few for a dense term) is
  copied into shared memory with asynchronous 16-byte copies, all in
  flight at once, so the block pays one memory round trip for its planes
  rather than one per decode; then the warps decode the rows, a row a
  warp in turn, storing their postings in the range's tile (a term holds
  a doc at most once, so no atomics), and each 16-byte word of the range
  is written once (a block per cell that zero-fills its tile in device
  memory and then scatters 4-byte stores writes every tile twice). The
  tiles can go into a caller's strided view (``out=``), so the hot-term
  planes are filled in place.

Host helpers ``pack_block_meta``, ``pad_planes`` and ``compute_cells`` and
the layout constants are copies of the reference's (that module imports
jax at module scope); tests/test_torch_postings.py holds each copy equal
to the original. ``decode_bytes`` and ``block_bytes`` count the bytes a
call must move, for its bound on the card (``utils/kernels.bound_ms``).
"""

from __future__ import annotations

import numpy as np
import torch

from trinity_tpu_torch.limits import TILE, WINDOW_SIZE

# Hard bounds for one (window, term) cell (copied from the reference, :63-81).
MAXB = 136  # max blocks per cell (>= 131), multiple of 8
MAXROWS = 208  # max packed word-rows per cell (>= ceil(131*48/32)+2)
C_POFF, C_BD, C_BF, C_FIRST, C_COUNT, C_HITS, C_LAST, C_MAXF = range(8)
META_COLS = 8
META_PER_ROW = 16  # blocks per bmeta row
META_ROWS = 16

_U32 = 0xFFFFFFFF


# ------------------------------------------------------------ host helpers
def pack_block_meta(seg) -> np.ndarray:
    """SegmentData block arrays -> (rows, 128) i32 device meta, 16 blocks per
    128-lane row (block b at row b//16, lanes (b%16)*8..+8)."""
    n = len(seg.block_plane_off)
    rows = -(-(n + MAXB) // META_PER_ROW) + META_ROWS
    m = np.zeros((rows * META_PER_ROW, META_COLS), np.int32)
    m[:n, C_POFF] = seg.block_plane_off
    m[:n, C_BD] = seg.block_bits_doc
    m[:n, C_BF] = seg.block_bits_freq
    m[:n, C_FIRST] = seg.block_first_doc
    m[:n, C_COUNT] = seg.block_count
    m[:n, C_HITS] = seg.block_hits_off
    m[:n, C_LAST] = seg.block_last_doc
    m[:n, C_MAXF] = seg.block_max_freq
    return m.reshape(rows, META_PER_ROW * META_COLS)


def pad_planes(planes: np.ndarray) -> np.ndarray:
    """Pad the packed plane matrix so a block's 3-row read stays in bounds."""
    pad = MAXROWS + 48
    return np.vstack([planes, np.zeros((pad, planes.shape[1]), planes.dtype)])


def compute_cells(seg, term_ids) -> tuple:
    """Per-(window, term) block ranges via vectorized skip-array search.

    term_ids: list of segment term ids (-1 for unknown terms -> empty cells).
    Returns (cell_start, cell_nblocks) i32[W, T]. Per-term columns are
    cached on the segment (they depend only on the immutable block arrays)."""
    W = seg.n_windows
    T = len(term_ids)
    cell_start = np.zeros((W, T), np.int32)
    cell_nblocks = np.zeros((W, T), np.int32)
    cache = getattr(seg, "_torch_cell_cache", None)
    if cache is None:
        cache = {}
        try:
            seg._torch_cell_cache = cache
        except AttributeError:
            pass
    bounds = np.arange(W + 1, dtype=np.int64) * WINDOW_SIZE
    for ti, tid in enumerate(term_ids):
        if tid < 0:
            continue
        hit = cache.get(tid)
        if hit is not None:
            cell_start[:, ti] = hit[0]
            cell_nblocks[:, ti] = hit[1]
            continue
        s = int(seg.term_block_start[tid])
        nb = int(seg.term_nblocks[tid])
        if nb == 0:
            continue
        lb = seg.block_last_doc[s : s + nb]
        fb = seg.block_first_doc[s : s + nb]
        starts = np.searchsorted(lb, bounds[:-1], side="left")
        ends = np.searchsorted(fb, bounds[1:], side="left")
        nbl = np.maximum(ends - starts, 0)
        if nbl.max(initial=0) > MAXB:
            raise ValueError("cell block bound exceeded")
        col_s = (s + starts).astype(np.int32)
        col_n = nbl.astype(np.int32)
        cache[tid] = (col_s, col_n)
        cell_start[:, ti] = col_s
        cell_nblocks[:, ti] = col_n
    return cell_start, cell_nblocks


# ------------------------------------------------------- plain torch decode
def _bitfield(wlo, whi, sh, width):
    """Bits [sh, sh+width) of the 64-bit value (wlo | whi << 32). All int64
    holding u32 values (so >> is logical); sh in [0, 32), width in [0, 32]."""
    lo = wlo >> sh
    hi = torch.where(sh == 0, 0, (whi << ((32 - sh) & 31)) & _U32)
    mask = torch.where(
        width >= 32, _U32, (1 << torch.clamp(width, 0, 31)) - 1
    )
    return (lo | hi) & mask


def decode_cells(bmeta, planes, cell_start, cell_nblocks, with_offsets=False):
    """Decode every block of every cell into (NB, 128) lane arrays, NB =
    total blocks over all cells. Returns (cell (NB,) row-major (w, t) cell
    index, docs absolute local docids, freq, hits offset | None, valid =
    lane < block count); all int64 but the bool mask."""
    dev = planes.device
    cs = cell_start.reshape(-1).to(torch.int64)
    cn = cell_nblocks.reshape(-1).to(torch.int64)
    cell = torch.repeat_interleave(torch.arange(len(cn), device=dev), cn)
    first_of_cell = torch.cumsum(cn, 0) - cn
    j = torch.arange(len(cell), device=dev) - first_of_cell[cell]
    blk = cs[cell] + j  # (NB,) global block ids
    meta = bmeta.reshape(-1, META_COLS)[blk].to(torch.int64)  # (NB, 8)
    poff = meta[:, C_POFF] & _U32
    row = (poff >> 5)[:, None]
    q = (poff & 31)[:, None]
    bd = meta[:, C_BD][:, None]
    bf = meta[:, C_BF][:, None]
    lanes = torch.arange(TILE, device=dev)[None, :]
    # u32 plane words held in int64, so shifts are logical
    w0, w1, w2 = (planes[row + i, lanes].to(torch.int64) & _U32
                  for i in range(3))
    deltas = _bitfield(w0, w1, q, bd)
    s2 = q + bd
    in_lo = s2 < 32
    f1 = _bitfield(
        torch.where(in_lo, w0, w1), torch.where(in_lo, w1, w2), s2 & 31, bf
    )
    docs = meta[:, C_FIRST][:, None] + torch.cumsum(deltas, 1)
    freq = f1 + 1
    valid = lanes < meta[:, C_COUNT][:, None]
    off = None
    if with_offsets:
        off = meta[:, C_HITS][:, None] + torch.cumsum(freq, 1) - freq
    return cell, docs, freq, off, valid


def materialize_freq_tiles_ref(
    bmeta, planes, cell_start, cell_nblocks, window_base=None,
    with_offsets=False, out=None, offs_out=None,
):
    """Plain torch version of the decode kernel (same contract as
    materialize_freq_tiles). Runs on any device."""
    W, T = cell_start.shape
    dev = planes.device
    if window_base is None:
        window_base = torch.arange(W, dtype=torch.int32, device=dev)
    cell, docs, freq, off, valid = decode_cells(
        bmeta, planes, cell_start, cell_nblocks, with_offsets
    )
    wb = window_base.to(torch.int64)[cell // T][:, None] * WINDOW_SIZE
    local = docs - wb
    valid = valid & (local >= 0) & (local < WINDOW_SIZE)
    idx = (cell[:, None] * WINDOW_SIZE + local)[valid]
    tiles = torch.zeros(W * T * WINDOW_SIZE, dtype=torch.float32, device=dev)
    tiles[idx] = freq[valid].to(torch.float32)
    tiles = tiles.reshape(W, T, TILE, TILE)
    if out is not None:
        _check_out(out, W, T, dev)
        tiles = out.copy_(tiles)
    if not with_offsets:
        return tiles
    offs = torch.zeros(W * T * WINDOW_SIZE, dtype=torch.int32, device=dev)
    # wrap to i32 like the reference's int32 arithmetic
    offs[idx] = (((off[valid] & _U32) ^ 0x80000000) - 0x80000000).to(
        torch.int32
    )
    offs = offs.reshape(W, T, TILE, TILE)
    if offs_out is not None:
        _check_offs_out(offs_out, W, T, dev)
        offs = offs_out.copy_(offs)
    return tiles, offs


# ------------------------------------------------------------ byte counts
def block_bytes(bmeta, cell_start, cell_nblocks) -> int:
    """Bytes of the distinct postings blocks a call's cells name: each
    block's metadata row (8 i32) and its plane bits (128 lanes of bd + bf
    bits). A block that two cells share (a window boundary) counts once."""
    dev = bmeta.device
    cs = cell_start.reshape(-1).to(torch.int64)
    cn = cell_nblocks.reshape(-1).to(torch.int64)
    cell = torch.repeat_interleave(torch.arange(len(cn), device=dev), cn)
    j = torch.arange(len(cell), device=dev) - (torch.cumsum(cn, 0) - cn)[cell]
    blk = torch.unique(cs[cell] + j)
    meta = bmeta.reshape(-1, META_COLS)[blk].to(torch.int64)
    bits = int((meta[:, C_BD] + meta[:, C_BF]).sum())
    return len(blk) * META_COLS * 4 + bits * TILE // 8


def decode_bytes(bmeta, cell_start, cell_nblocks, with_offsets=False) -> int:
    """Bytes one materialize_freq_tiles call must move: the tiles written
    once (W * T * 64 KiB, twice with offsets), the cell tables and the
    distinct blocks (block_bytes)."""
    W, T = cell_start.shape
    tiles = W * T * WINDOW_SIZE * 4 * (2 if with_offsets else 1)
    return (tiles + 2 * W * T * 4
            + block_bytes(bmeta, cell_start, cell_nblocks))


# ----------------------------------------------------------------- wrapper
def _check(t, name, dtype, dev):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_out(out, W, T, dev):
    """A freq destination: f32 (W, T, 128, 128) on `dev` whose tiles are
    each contiguous (e.g. a slice of a (C, W, 128, 128) cache, transposed)."""
    if out.dtype != torch.float32 or out.device != dev:
        raise TypeError(f"out: expected float32 on {dev}")
    if tuple(out.shape) != (W, T, TILE, TILE):
        raise ValueError(f"out: shape {tuple(out.shape)}, expected "
                         f"{(W, T, TILE, TILE)}")
    if out.stride()[2:] != (TILE, 1):
        raise ValueError("out: each tile must be contiguous")


def _check_offs_out(offs_out, W, T, dev):
    """A hit-offsets destination: contiguous i32 (W, T, 128, 128) on `dev`,
    16-byte aligned (e.g. a view of a workspace)."""
    if offs_out.dtype != torch.int32 or offs_out.device != dev:
        raise TypeError(f"offs_out: expected int32 on {dev}")
    if tuple(offs_out.shape) != (W, T, TILE, TILE):
        raise ValueError(f"offs_out: shape {tuple(offs_out.shape)}, "
                         f"expected {(W, T, TILE, TILE)}")
    if not offs_out.is_contiguous() or offs_out.data_ptr() % 16:
        raise ValueError("offs_out: must be contiguous and 16-byte aligned")


def materialize_freq_tiles(
    bmeta: torch.Tensor,  # (rows, 128) i32 (pack_block_meta)
    planes: torch.Tensor,  # (R_pad, 128) i32 bit-view of u32, padded
    cell_start: torch.Tensor,  # (W, T) i32
    cell_nblocks: torch.Tensor,  # (W, T) i32
    window_base: torch.Tensor = None,  # (W,) i32 window ids (default arange)
    with_offsets: bool = False,
    out: torch.Tensor = None,  # freq destination (W, T, 128, 128) f32 view
    offs_out: torch.Tensor = None,  # offsets destination, contiguous i32
):
    """Returns f32[W, T, 128, 128] frequency tiles (0 = term absent); with
    with_offsets also i32[W, T, 128, 128] hits-offset tiles. The freq
    tiles are written into `out` when given (any view whose tiles are each
    contiguous, e.g. ``cache[i:i + T].transpose(0, 1)``) and returned; the
    offsets into `offs_out` when given (a contiguous view, e.g. of a
    workspace).

    On CUDA tensors this launches the decode kernel (csrc/postings.cu); on
    CPU tensors it runs materialize_freq_tiles_ref."""
    if planes.device.type != "cuda":
        return materialize_freq_tiles_ref(
            bmeta, planes, cell_start, cell_nblocks, window_base,
            with_offsets, out, offs_out,
        )
    from trinity_tpu_torch.utils import kernels

    dev = planes.device
    W, T = cell_start.shape
    if window_base is None:
        window_base = torch.arange(W, dtype=torch.int32, device=dev)
    for t, name in ((bmeta, "bmeta"), (planes, "planes"),
                    (cell_start, "cell_start"), (cell_nblocks, "cell_nblocks"),
                    (window_base, "window_base")):
        _check(t, name, torch.int32, dev)
    if planes.dim() != 2 or planes.shape[1] != TILE or bmeta.shape[-1] != TILE:
        raise ValueError("planes and bmeta must be (rows, 128)")
    if cell_nblocks.shape != (W, T) or window_base.shape != (W,):
        raise ValueError("cell tables must be (W, T), window_base (W,)")
    if out is None:  # contiguous: the tile strides need no check
        out = torch.empty((W, T, TILE, TILE), dtype=torch.float32, device=dev)
        strides = (T * WINDOW_SIZE, WINDOW_SIZE)
    else:
        _check_out(out, W, T, dev)
        strides = out.stride()[:2]
        if out.data_ptr() % 16 or strides[0] % 4 or strides[1] % 4:
            raise ValueError("out: every tile must be 16-byte aligned")
    offs = None
    if with_offsets and offs_out is not None:
        _check_offs_out(offs_out, W, T, dev)
        offs = offs_out
    elif with_offsets:
        offs = torch.empty((W, T, TILE, TILE), dtype=torch.int32, device=dev)
    if W * T:
        kernels.launch(
            "decode", "trin_decode_tiles",
            bmeta, planes, cell_start, cell_nblocks, window_base, W, T,
            out, *strides, offs,
        )
    return (out, offs) if with_offsets else out
