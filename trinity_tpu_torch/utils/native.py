# Copy of trinity_tpu/utils/native.py; only its imports name the port.
"""ctypes bindings to the native host library (native/trinity_host.cpp).

The reference's hot host paths are native C++ (PFor encode ~69% of indexing
time, indexer.cpp:302-310; terms dict pack, terms.cpp:126-172). This module
loads the optional `libtrinity_host.so` and exposes the same operations;
every caller has a numpy fallback, so the library is an accelerator, not a
dependency. Build it with `make -C native`.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load() -> Optional[ctypes.CDLL]:
    """Load libtrinity_host.so if built; returns None otherwise."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.environ.get(
        "TRINITY_HOST_LIB",
        os.path.join(_repo_root(), "native", "libtrinity_host.so"),
    )
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.trin_build_blocks.restype = ctypes.c_int64
    lib.trin_build_blocks.argtypes = [
        ctypes.c_int64, i64p, u32p, u32p, u32p,
        u32p, u32p, u32p, i32p, u8p, u8p, u32p, u32p,
    ]
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.trin_pack_value_groups.restype = ctypes.c_int64
    lib.trin_pack_value_groups.argtypes = [ctypes.c_int64, u32p, u32p, u8p]
    lib.trin_pack_terms.restype = ctypes.c_int64
    lib.trin_pack_terms.argtypes = [
        ctypes.c_int64, u8p, i64p, ctypes.c_int,
        u8p, u32p, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.trin_decode_blocks.restype = ctypes.c_int64
    lib.trin_decode_blocks.argtypes = [
        ctypes.c_int64, u32p, u32p, u8p, u8p, u32p, i32p, u32p, u32p,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return load() is not None


def build_blocks(
    posting_start: np.ndarray,  # i64 [n_terms+1]
    p_doc: np.ndarray,  # u32 [n]
    p_freq: np.ndarray,  # u32 [n]
    p_hits_off: np.ndarray,  # u32 [n]
    n_blocks: int,
) -> Optional[Tuple]:
    """Native block build; returns the SegmentData block arrays + planes, or
    None when the library isn't built."""
    lib = load()
    if lib is None:
        return None
    n_terms = len(posting_start) - 1
    block_plane_off = np.zeros(n_blocks, np.uint32)
    block_first = np.zeros(n_blocks, np.uint32)
    block_last = np.zeros(n_blocks, np.uint32)
    block_count = np.zeros(n_blocks, np.int32)
    bits_doc = np.zeros(n_blocks, np.uint8)
    bits_freq = np.zeros(n_blocks, np.uint8)
    block_hits_off = np.zeros(n_blocks, np.uint32)
    worst_rows = -(-(n_blocks * 48) // 32) + 2
    planes = np.zeros((worst_rows, 128), np.uint32)
    used = lib.trin_build_blocks(
        n_terms,
        np.ascontiguousarray(posting_start, np.int64),
        np.ascontiguousarray(p_doc, np.uint32),
        np.ascontiguousarray(p_freq, np.uint32),
        np.ascontiguousarray(p_hits_off, np.uint32),
        block_plane_off,
        block_first,
        block_last,
        block_count,
        bits_doc,
        bits_freq,
        block_hits_off,
        planes,
    )
    if used < 0:
        raise ValueError("native block build rejected postings (order/freq)")
    rows = -(-int(used) // 32)
    # block max freq (WAND bound): one segmented reduction over postings
    if n_blocks:
        nb = np.maximum((np.diff(posting_start) + 127) // 128, 0)
        base = np.repeat(posting_start[:-1], nb)
        intra = np.arange(n_blocks) - np.repeat(np.cumsum(nb) - nb, nb)
        starts = (base + intra * 128).astype(np.int64)
        bmax = np.maximum.reduceat(p_freq, starts).astype(np.uint16)
    else:
        bmax = np.zeros(0, np.uint16)
    return (
        block_plane_off,
        block_first,
        block_last,
        block_count,
        bits_doc,
        bits_freq,
        block_hits_off,
        bmax,
        planes[:rows].copy(),
    )


def pack_terms(terms, interval: int = 64) -> Optional[Tuple]:
    """Native prefix-compressed terms pack; None if lib missing."""
    lib = load()
    if lib is None:
        return None
    blobs = [t if isinstance(t, bytes) else t.encode() for t in terms]
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    blob = np.frombuffer(b"".join(blobs) or b"\0", np.uint8)
    # worst case: 10 varint bytes + full term per entry
    data = np.zeros(int(offsets[-1]) + 10 * max(1, len(blobs)), np.uint8)
    skips = np.zeros(2 * (-(-max(1, len(blobs)) // interval)), np.uint32)
    n_skips = ctypes.c_int64(0)
    used = lib.trin_pack_terms(
        len(blobs), blob, offsets, interval, data, skips, ctypes.byref(n_skips)
    )
    return data[:used].copy(), skips[: 2 * n_skips.value].reshape(-1, 2).copy()


def pack_value_groups(values: np.ndarray):
    """Native positions-stream pack (same contract as
    bitpack.pack_value_groups); None when the library isn't built."""
    lib = load()
    if lib is None:
        return None
    n = len(values)
    if n == 0:
        return np.zeros((0, 128), np.uint32), np.zeros(1, np.uint32)
    n_groups = -(-n // 128)
    worst_rows = n_groups + 1  # 32 bits/group max -> 1 word-row per group
    words = np.zeros((worst_rows + 1, 128), np.uint32)
    gbits = np.zeros(n_groups, np.uint8)
    used = lib.trin_pack_value_groups(
        n, np.ascontiguousarray(values, np.uint32), words, gbits
    )
    off = np.zeros(n_groups + 1, np.uint32)
    np.cumsum(gbits, out=off[1:])
    rows = -(-int(used) // 32)
    return words[:rows].copy(), off


def decode_blocks(seg) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Whole-segment postings decode -> (docids u32, freqs u32), in block
    order (term-major). The merge/compaction hot path (the codec-native
    N-way merge role, lucene_codec.cpp:963-1393). None if lib missing."""
    lib = load()
    if lib is None:
        return None
    n_blocks = len(seg.block_plane_off)
    total = int(seg.block_count.sum()) if n_blocks else 0
    out_docs = np.zeros(total, np.uint32)
    out_freqs = np.zeros(total, np.uint32)
    if n_blocks == 0:
        return out_docs, out_freqs
    n = lib.trin_decode_blocks(
        n_blocks,
        np.ascontiguousarray(seg.planes.reshape(-1), np.uint32),
        np.ascontiguousarray(seg.block_plane_off, np.uint32),
        np.ascontiguousarray(seg.block_bits_doc, np.uint8),
        np.ascontiguousarray(seg.block_bits_freq, np.uint8),
        np.ascontiguousarray(seg.block_first_doc, np.uint32),
        np.ascontiguousarray(seg.block_count, np.int32),
        out_docs,
        out_freqs,
    )
    if n != total:
        raise ValueError(f"native decode wrote {n} of {total} postings")
    return out_docs, out_freqs


def decode_blocks_range(seg, b0: int, b1: int):
    """Postings decode of the contiguous block range [b0, b1) ->
    (docids u32, freqs u32) in block order. Plane offsets are absolute
    into seg.planes, so slicing only the block metadata arrays suffices —
    this is the bounded-memory merge cursor (only one term partition's
    blocks decode at a time). None if lib missing."""
    lib = load()
    if lib is None:
        return None
    nb = b1 - b0
    total = int(seg.block_count[b0:b1].sum()) if nb > 0 else 0
    out_docs = np.zeros(total, np.uint32)
    out_freqs = np.zeros(total, np.uint32)
    if nb <= 0:
        return out_docs, out_freqs
    n = lib.trin_decode_blocks(
        nb,
        np.ascontiguousarray(seg.planes.reshape(-1), np.uint32),
        np.ascontiguousarray(seg.block_plane_off[b0:b1], np.uint32),
        np.ascontiguousarray(seg.block_bits_doc[b0:b1], np.uint8),
        np.ascontiguousarray(seg.block_bits_freq[b0:b1], np.uint8),
        np.ascontiguousarray(seg.block_first_doc[b0:b1], np.uint32),
        np.ascontiguousarray(seg.block_count[b0:b1], np.int32),
        out_docs,
        out_freqs,
    )
    if n != total:
        raise ValueError(f"native decode wrote {n} of {total} postings")
    return out_docs, out_freqs
