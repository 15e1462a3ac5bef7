"""Random inputs of a posmask phrase group, for the phrase score kernel.

``phrase_group`` makes the position words of a few term columns, split
between a posmask call's output (``masks``) and a posmask hot cache
(``cache``), and a (B, K) member table over them. Docs fall in three
classes, shared by every term: no bit set (the phrase cannot match: -inf),
words of density 3/4 and words of density 31/32 (so the AND of up to 16
shifted members still leaves bits). Every bit of a word is drawn, bit 31
included, so the shifts carry bits across words. Row 0 repeats its first
member (a phrase such as "a a"); the other rows mix masks and cache
columns. Imports only numpy and the port's torch (the CUDA tests need no
jax).
"""

import numpy as np
import torch

from trinity_tpu_torch.limits import TILE, WINDOW_SIZE


def _words(rng, shape, n_or):
    """i32 words whose bits are each set with probability 1 - 2**-n_or."""
    out = np.zeros(shape, np.uint32)
    for _ in range(n_or):
        out |= rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
            np.uint32)
    return out


def phrase_group(seed, W, B, K, PW, n_masks, n_cache, dead, device="cpu"):
    """(masks (W, n_masks, PW, 128, 128) i32 or None, cache (W, n_cache,
    PW, 128, 128) i32 or None, members (B, K) i32, weights (B,) f32,
    deleted (W, 128, 128) f32 or None), all on `device`."""
    rng = np.random.default_rng(seed)
    n = n_masks + n_cache
    cls = rng.integers(0, 3, size=(W, 1, 1, WINDOW_SIZE))
    words = np.where(cls == 2, _words(rng, (W, n, PW, WINDOW_SIZE), 5),
                     _words(rng, (W, n, PW, WINDOW_SIZE), 2))
    words = np.where(cls == 0, np.uint32(0), words).astype(np.uint32)
    words = words.view(np.int32).reshape(W, n, PW, TILE, TILE)
    cols = rng.integers(0, n, size=(B, K))
    if K > 1:
        cols[0, 1] = cols[0, 0]
    members = np.where(cols < n_masks, cols, -1 - (cols - n_masks))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    masks = put(words[:, :n_masks]) if n_masks else None
    cache = put(words[:, n_masks:]) if n_cache else None
    weights = rng.uniform(0.5, 9.0, size=B).astype(np.float32)
    deleted = None
    if dead:
        deleted = put((rng.random((W, TILE, TILE)) < 0.1).astype(np.float32))
    return masks, cache, put(members.astype(np.int32)), put(weights), deleted
