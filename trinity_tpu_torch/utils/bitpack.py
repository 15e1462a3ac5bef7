# Copy of trinity_tpu/utils/bitpack.py; only its imports name the port.
"""Bit-plane packing of postings blocks (host/numpy reference implementation).

The TPU-native replacement for FastPFor SIMD bit-packing
(lucene_codec.h:20-34, Makefile:22-28). The segment's compressed postings
form one global **plane matrix**: a (total_planes, 128)-bit matrix whose row
``p`` holds bit ``j`` of a 128-value block's values (deltas or freqs), for
each block's planes stacked consecutively. The matrix is packed 32 plane-rows
per u32 into a ``(ceil(P/32), 128)`` u32 array ("PW"): bit ``j`` of word
``PW[r, l]`` is plane row ``32*r + j``, value lane ``l``.

This transposed layout is chosen *for the hardware*: a block's planes span at
most 3 consecutive 128-lane word-rows, so the Pallas decoder
(trinity_tpu/ops) does one row-aligned DMA, a single broadcast-shift
bit-expand over sublanes, and two weighted sublane reductions — no gathers,
no lane-dim reshapes, no per-word extraction. Packing stays perfect
(exact max-bit-width per block, zero padding between blocks), preserving
index-memory parity with the reference's PFor blocks.

A block with bit width 0 (all deltas zero / all freqs equal to 1) occupies
zero planes — the analog of the lucene codec's all-equal fast path
(lucene_codec.cpp:31-39).
"""

from __future__ import annotations

import numpy as np

from trinity_tpu_torch.limits import BLOCK_SIZE

PLANES_PER_ROW = 32  # u32 word packs 32 plane rows


def bit_width(max_value: int) -> int:
    """Number of bits needed to represent ``max_value`` (0 -> 0 bits)."""
    return int(max_value).bit_length()


def plane_rows(values: np.ndarray, bits: int) -> np.ndarray:
    """Bit rows of up to BLOCK_SIZE values -> (bits, 128) uint32 in {0,1}.

    Row ``j`` is bit ``j`` of every value; values beyond len(values) are 0.
    """
    n = len(values)
    assert n <= BLOCK_SIZE
    if bits == 0:
        return np.zeros((0, BLOCK_SIZE), np.uint32)
    v = np.zeros(BLOCK_SIZE, dtype=np.uint64)
    v[:n] = np.asarray(values, dtype=np.uint64)
    assert bits >= bit_width(int(v.max(initial=0))), "bit width too small"
    j = np.arange(bits, dtype=np.uint64)[:, None]
    return ((v[None, :] >> j) & 1).astype(np.uint32)


def pack_plane_matrix(rows: np.ndarray) -> np.ndarray:
    """Pack a (P, 128) 0/1 bit matrix into (ceil(P/32), 128) u32 words."""
    P = len(rows)
    R = -(-P // PLANES_PER_ROW) if P else 0
    if not R:
        return np.zeros((0, BLOCK_SIZE), np.uint32)
    padded = np.zeros((R * PLANES_PER_ROW, BLOCK_SIZE), np.uint32)
    padded[:P] = rows
    shifts = np.arange(PLANES_PER_ROW, dtype=np.uint32)[None, :, None]
    return (
        (padded.reshape(R, PLANES_PER_ROW, BLOCK_SIZE).astype(np.uint64) << shifts)
        .sum(axis=1, dtype=np.uint64)
        & 0xFFFFFFFF
    ).astype(np.uint32)


def pack_value_groups(values: np.ndarray):
    """Pack a flat value stream into 128-value plane-packed groups.

    Returns (pw (R,128) u32, group_plane_off u32[n_groups+1]): group g's
    values occupy plane rows [off[g], off[g+1]) with bit width
    off[g+1]-off[g]. Used for the positions ("hits") stream — random access
    decodes 1-2 groups (format.py PositionsView).
    """
    H = len(values)
    if H == 0:
        return np.zeros((0, BLOCK_SIZE), np.uint32), np.zeros(1, np.uint32)
    G = -(-H // BLOCK_SIZE)
    CHUNK = 16384  # groups per pass: peak RAM stays O(CHUNK), so a disk
    # memmap stream (the partitioned commit's positions scratch) packs
    # without ever materializing the full corpus in memory

    def _group_chunk(g0, g1, dtype):
        c = np.zeros((g1 - g0) * BLOCK_SIZE, dtype)
        v0 = g0 * BLOCK_SIZE
        v1 = min(g1 * BLOCK_SIZE, H)
        c[: v1 - v0] = values[v0:v1]
        return c.reshape(g1 - g0, BLOCK_SIZE)

    maxes = np.zeros(G, np.int64)
    for g0 in range(0, G, CHUNK):
        g1 = min(g0 + CHUNK, G)
        maxes[g0:g1] = _group_chunk(g0, g1, np.int64).max(axis=1)
    bits = np.zeros(G, np.int64)
    nz = maxes > 0
    bits[nz] = np.floor(np.log2(maxes[nz].astype(np.float64))).astype(np.int64) + 1
    # float log2 rounding guard: widths must cover every value exactly
    bad = (maxes >> np.minimum(bits, 63)) > 0
    bits[bad] += 1
    off = np.zeros(G + 1, np.uint32)
    np.cumsum(bits, out=off[1:])
    total_rows = int(off[-1])
    R = -(-total_rows // PLANES_PER_ROW)
    out = np.zeros((R + 1, BLOCK_SIZE), np.uint32)
    # chunked pack: plane rows are group-major and contiguous, so each chunk
    # packs into a contiguous word-row range (boundary rows OR-merge)
    for g0 in range(0, G, CHUNK):
        g1 = min(g0 + CHUNK, G)
        P2c = _group_chunk(g0, g1, np.uint64)
        cb = bits[g0:g1]
        row_g = np.repeat(np.arange(g0, g1), cb)
        co = off[g0:g1].astype(np.int64)
        row_j = (np.arange(len(row_g)) + int(off[g0]) - np.repeat(co, cb)).astype(
            np.uint64
        )
        rows = ((P2c[row_g - g0] >> row_j[:, None]) & 1).astype(np.uint32)
        pr0 = int(off[g0])
        lead = pr0 % PLANES_PER_ROW
        padded_len = -(-(lead + len(rows)) // PLANES_PER_ROW) * PLANES_PER_ROW
        buf = np.zeros((padded_len, BLOCK_SIZE), np.uint32)
        buf[lead : lead + len(rows)] = rows
        shifts = np.arange(PLANES_PER_ROW, dtype=np.uint32)[None, :, None]
        words = (
            (
                buf.reshape(-1, PLANES_PER_ROW, BLOCK_SIZE).astype(np.uint64)
                << shifts
            ).sum(axis=1, dtype=np.uint64)
            & 0xFFFFFFFF
        ).astype(np.uint32)
        r0 = pr0 // PLANES_PER_ROW
        out[r0 : r0 + len(words)] |= words
    return out[:R], off


def unpack_value_groups(pw: np.ndarray, off: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Gather values at flat indices from a pack_value_groups stream.

    Vectorized contiguous-bit-field extraction (same trick as the device
    decoder in ops/postings.py): value = bits [s, s+b) of the 64-bit lane
    column word pair, where s = group plane offset % 32.
    """
    idx = np.asarray(idx, np.int64)
    g = idx // BLOCK_SIZE
    lane = idx % BLOCK_SIZE
    p0 = off[g].astype(np.int64)
    b = (off[g + 1] - off[g]).astype(np.int64)
    r0 = p0 // 32
    sh = (p0 % 32).astype(np.uint64)
    n_rows = len(pw)
    w0 = pw[np.minimum(r0, max(0, n_rows - 1)), lane].astype(np.uint64)
    w1 = pw[np.minimum(r0 + 1, max(0, n_rows - 1)), lane].astype(np.uint64)
    field = (w0 >> sh) | np.where(sh > 0, w1 << (np.uint64(32) - sh), 0)
    mask = (np.uint64(1) << b.astype(np.uint64)) - np.uint64(1)
    return (field & mask).astype(np.uint32)


def unpack_plane_rows(pw: np.ndarray, p0: int, bits: int) -> np.ndarray:
    """Extract plane rows [p0, p0+bits) from packed matrix -> (bits, 128)."""
    if bits == 0:
        return np.zeros((0, BLOCK_SIZE), np.uint32)
    p = np.arange(p0, p0 + bits)
    return (pw[p // PLANES_PER_ROW] >> (p % PLANES_PER_ROW)[:, None]) & 1


def values_from_planes(rows: np.ndarray, count: int = BLOCK_SIZE) -> np.ndarray:
    """Inverse of plane_rows: (bits, 128) rows -> u32 values[:count]."""
    if len(rows) == 0:
        return np.zeros(count, np.uint32)
    j = np.arange(len(rows), dtype=np.uint64)[:, None]
    vals = (rows.astype(np.uint64) << j).sum(axis=0) & 0xFFFFFFFF
    return vals.astype(np.uint32)[:count]
