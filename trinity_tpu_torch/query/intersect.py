"""Co-occurrence mining: which subsets of query tokens match together.

Counterpart of ``trinity_tpu/query/intersect.py``; ``intersect`` and
``intersection_alternatives`` are copies (:69-123) but for the device call.
The analog of intersect.{h,cpp}: the reference runs an N-way merge across
up to 64 token-groups' postings, building a per-document token bitmask and
counting distinct masks, deduplicating dominated ones (intersect.cpp:5-170);
``intersection_alternatives`` ranks the surviving subsets as "did you mean"
candidates (intersect.cpp:219-327).

The device pass (``presence_masks``, the reference's ``_build_mask_fn``)
is torch over the decode kernel K1 without offsets at T = the token count
(up to 64): each token's presence bit packed into one 64-bit word per
document on the card (bit i = token i present), zero for the documents
past the segment's end, then copied back and histogrammed on the host
(the result set is tiny: at most one entry per distinct mask). The
reference split the bits over 30-bit int32 planes, a TPU workaround; here
the word is an int64 whose bit 63 is the 64th token, read as uint64 on the
host, so the output is the reference's exactly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from trinity_tpu_torch.limits import WINDOW_SIZE

MAX_INTERSECT_TOKENS = 64  # reference parity (intersect.h uint64_t masks)


def presence_masks(executor, cs: np.ndarray, cn: np.ndarray) -> torch.Tensor:
    """Decode every window of the cells (cs, cn: (W, T) i32, T <= 64) with
    K1 and pack each document's presence bits: (W * 16384,) int64, bit i
    set when token i occurs, 0 past the segment's last document."""
    from trinity_tpu_torch.ops.postings import materialize_freq_tiles

    W, T = cs.shape
    tiles = materialize_freq_tiles(executor.bmeta, executor.planes,
                                   executor._put(cs), executor._put(cn))
    present = tiles.reshape(W, T, WINDOW_SIZE) > 0
    # bit i as an int64 (bit 63 is the sign bit; uint64 on the host)
    bits = np.left_shift(np.uint64(1), np.arange(T, dtype=np.uint64))
    words = torch.zeros((W, WINDOW_SIZE), dtype=torch.int64,
                        device=tiles.device)
    for i, b in enumerate(bits.view(np.int64).tolist()):
        words |= torch.where(present[:, i], b, 0)
    gid = torch.arange(W * WINDOW_SIZE, device=tiles.device)
    return torch.where(gid < executor.seg.n_docs, words.reshape(-1), 0)


def intersect(executor, tokens: Sequence[str]) -> List[Tuple[int, int]]:
    """Returns [(token bitmask, document count)] sorted by count desc,
    dominated masks removed: a mask is dropped if a strict superset matches
    at least as many documents (intersect.cpp:5-170 dedup semantics).

    On a CUDA executor the decode launches K1; on a CPU executor it runs
    the kernel's plain version."""
    if len(tokens) > MAX_INTERSECT_TOKENS:
        raise ValueError(f"at most {MAX_INTERSECT_TOKENS} tokens")
    from trinity_tpu_torch.ops.postings import compute_cells
    from trinity_tpu_torch.utils import seal

    seg = executor.seg
    tids = [seg.term_id(t) for t in tokens]
    cs, cn = compute_cells(seg, tids)
    seal.record(("intersect", len(tokens)))
    masks = presence_masks(executor, cs, cn).cpu().numpy().view(np.uint64)
    # uint64 .tolist() yields non-negative Python ints (bit 63 safe)
    vals, counts = np.unique(masks[masks != 0], return_counts=True)
    pairs = sorted(zip(vals.tolist(), counts.tolist()), key=lambda p: -p[1])
    # drop dominated masks: strict subset with count <= a superset's count
    out = []
    for m, c in pairs:
        dominated = any(
            (m & m2) == m and m != m2 and c2 >= c for m2, c2 in pairs
        )
        if not dominated:
            out.append((m, c))
    return out


def intersection_alternatives(
    executor, tokens: Sequence[str], min_count: int = 1
) -> List[Tuple[List[str], int]]:
    """'Did you mean' / query relaxation: token subsets that co-occur,
    largest and most frequent first (intersection_alternatives analog,
    intersect.cpp:219-327)."""
    res = intersect(executor, tokens)
    out = []
    for mask, count in res:
        if count < min_count:
            continue
        subset = [t for i, t in enumerate(tokens) if mask & (1 << i)]
        out.append((subset, count))
    out.sort(key=lambda p: (-len(p[0]), -p[1]))
    return out
