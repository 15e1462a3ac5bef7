"""Postings blocks built by hand, for decode inputs a builder never makes.

A builder cuts each term's postings into full 128-posting blocks with the
narrowest bit widths, so at most 18 of its blocks meet a 2048-doc range and
their plane rows span a few rows. ``wide_blocks`` makes one term column
whose blocks are partial (48 postings) and padded to wide fields (30-bit
doc deltas, 16-bit freqs): 40 of them lie in docs [64, 2112) of window 0,
so one 2048-doc range meets all 40, and their plane rows span ~58 rows;
then 6 full blocks spread over windows 0-1, one of them across the
boundary. Imports only numpy and the port (the CUDA tests need no jax).
"""

from types import SimpleNamespace

import numpy as np

from trinity_tpu_torch.ops.postings import compute_cells, pack_block_meta, pad_planes
from trinity_tpu_torch.utils.bitpack import pack_plane_matrix, plane_rows


def wide_blocks(seed=5):
    """(bmeta (rows, 128) i32, planes (R, 128) u32 padded, cell_start,
    cell_nblocks (2, 2) i32): column 0 the hand-made term, column 1 an
    unknown term (empty cells)."""
    rng = np.random.default_rng(seed)
    dense = np.sort(rng.choice(np.arange(64, 2112), 40 * 48, replace=False))
    spread = np.sort(rng.choice(np.arange(12_000, 30_000), 6 * 128,
                                replace=False))
    blocks = [(dense[i : i + 48], 30) for i in range(0, len(dense), 48)]
    blocks += [(spread[i : i + 128], None) for i in range(0, len(spread), 128)]
    cols = {k: [] for k in ("block_plane_off", "block_bits_doc",
                            "block_bits_freq", "block_first_doc",
                            "block_count", "block_hits_off", "block_last_doc",
                            "block_max_freq")}
    rows, poff, hits = [], 0, 0
    for docs, bd in blocks:
        deltas = np.diff(docs, prepend=docs[0]).astype(np.uint64)
        bd = bd or int(deltas.max()).bit_length()
        f1 = rng.integers(0, 1 << 16, size=len(docs)).astype(np.uint64)
        rows += [plane_rows(deltas, bd), plane_rows(f1, 16)]
        for k, v in (("block_plane_off", poff), ("block_bits_doc", bd),
                     ("block_bits_freq", 16), ("block_first_doc", docs[0]),
                     ("block_count", len(docs)), ("block_hits_off", hits),
                     ("block_last_doc", docs[-1]),
                     ("block_max_freq", min(int(f1.max()) + 1, 65535))):
            cols[k].append(v)
        poff += bd + 16
        hits += int((f1 + 1).sum())
    seg = SimpleNamespace(
        n_windows=2, term_block_start=np.array([0]),
        term_nblocks=np.array([len(blocks)]),
        **{k: np.array(v, np.uint32) for k, v in cols.items()})
    cs, cn = compute_cells(seg, [0, -1])
    planes = pad_planes(pack_plane_matrix(np.concatenate(rows)))
    return pack_block_meta(seg), planes, cs, cn
