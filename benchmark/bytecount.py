"""The least bytes a batch of queries must move on the device.

A frozen count, independent of how the port plans or launches: for each
source searched and each distinct term of the batch, once, its posting
blocks as the segment lays them out (32 bytes of block metadata and
128 x (bits_doc + bits_freq) / 8 bytes of packed ids and frequencies a
block), and, for a term inside a phrase, the rows of the positions stream
that hold its hits (128 u32 a row); plus the top-k written once a query
(an f32 score and an i32 id an entry). It counts the blocks of a term's
whole posting list: a path that skips blocks (block-max pruning, galloping
AND) needs this count redone before its share is read.
"""

from __future__ import annotations

import numpy as np

from benchmark.querygen import spec_terms

H100_BYTES_PER_S = 3.35e12  # NVIDIA's data sheet, H100 SXM at 700 W
META_BYTES = 32
BLOCK = 128


def term_bytes(seg, tid: int, phrase: bool) -> int:
    """Posting-block bytes of term id `tid` in `seg`, with its position
    rows when `phrase`."""
    a = int(seg.term_block_start[tid])
    b = a + int(seg.term_nblocks[tid])
    bits = (seg.block_bits_doc[a:b].astype(np.int64)
            + seg.block_bits_freq[a:b].astype(np.int64))
    n = (b - a) * META_BYTES + int(bits.sum()) * BLOCK // 8
    if phrase and b > a:
        h0 = int(seg.block_hits_off[a])
        h1 = h0 + int(seg.term_sum_hits[tid])
        g0, g1 = h0 // BLOCK, -(-h1 // BLOCK)
        off = seg.hit_group_off
        n += int(off[g1] - off[g0]) * BLOCK * 4
    return n


def batch_bytes(segs: list, specs: list, k: int) -> int:
    """Least bytes of one batch of query specs over the segments searched."""
    terms, phrase = set(), set()
    for s in specs:
        a, b = spec_terms(s)
        terms |= a
        phrase |= b
    n = len(specs) * k * 8
    for seg in segs:
        if seg.n_docs == 0:
            continue
        for t in terms:
            tid = seg.term_id(f"w{t}")
            if tid >= 0:
                n += term_bytes(seg, tid, t in phrase)
    return n
