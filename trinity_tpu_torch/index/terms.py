# Copy of trinity_tpu/index/terms.py; only its imports name the port.
"""Terms dictionary: prefix-compressed sorted blocks + skip index.

Host-side analog of the reference's terms dictionary (terms.cpp:126-172
pack_terms, terms.cpp:8-103 lookup): terms are sorted by byte comparison
(terms_cmp, common.h:50-58) and stored prefix-compressed — each entry is
(shared-prefix length, suffix length, suffix bytes) as varints — with a skip
entry every SKIPLIST_INTERVAL terms recording (ordinal, byte offset) so a
lookup is a binary search over the skip index plus a bounded linear
prefix-decode scan.
"""

from __future__ import annotations

import numpy as np

SKIPLIST_INTERVAL = 64  # terms.cpp: SKIPLIST_INTERVAL = 64


def _put_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _get_varint(buf, pos: int):
    v = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v, pos
        shift += 7


def _shared_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


def pack_terms(terms: list) -> tuple:
    """Pack sorted term list -> (data u8 array, skip u32 array [k, 2]).

    skip[:, 0] = term ordinal, skip[:, 1] = byte offset of its entry; entries
    at skip points are stored with zero shared prefix so decoding can start
    there (terms.cpp:126-172 semantics). Uses the native packer when built.
    """
    from trinity_tpu_torch.utils import native

    packed = native.pack_terms(terms, SKIPLIST_INTERVAL)
    if packed is not None:
        return packed
    data = bytearray()
    skips = []
    prev = b""
    for i, t in enumerate(terms):
        if isinstance(t, str):
            t = t.encode("utf-8")
        if i % SKIPLIST_INTERVAL == 0:
            skips.append((i, len(data)))
            shared = 0
        else:
            shared = _shared_prefix(prev, t)
        _put_varint(data, shared)
        _put_varint(data, len(t) - shared)
        data.extend(t[shared:])
        prev = t
    return (
        np.frombuffer(bytes(data), dtype=np.uint8),
        np.array(skips, dtype=np.uint32).reshape(-1, 2),
    )


def unpack_terms(data: np.ndarray, idx: np.ndarray) -> list:
    """Full streaming decode (terms_data_view::iterator analog,
    terms.cpp:224-255)."""
    buf = data.tobytes()
    out = []
    pos = 0
    prev = b""
    n = len(buf)
    while pos < n:
        shared, pos = _get_varint(buf, pos)
        slen, pos = _get_varint(buf, pos)
        t = prev[:shared] + buf[pos : pos + slen]
        pos += slen
        out.append(t)
        prev = t
    return out


def lookup_term(data: np.ndarray, idx: np.ndarray, term) -> int:
    """Binary search skip index + linear block scan -> ordinal or -1
    (terms.cpp:8-103)."""
    if isinstance(term, str):
        term = term.encode("utf-8")
    if len(idx) == 0:
        return -1
    buf = data.tobytes()
    # binary search over skip entries: find last skip whose term <= target
    lo, hi = 0, len(idx) - 1
    best = 0
    while lo <= hi:
        mid = (lo + hi) // 2
        pos = int(idx[mid, 1])
        shared, pos = _get_varint(buf, pos)
        slen, pos = _get_varint(buf, pos)
        t = buf[pos : pos + slen]  # skip entries have shared == 0
        if t <= term:
            best = mid
            lo = mid + 1
        else:
            hi = mid - 1
    ordinal = int(idx[best, 0])
    pos = int(idx[best, 1])
    prev = b""
    end = int(idx[best + 1, 1]) if best + 1 < len(idx) else len(buf)
    while pos < end:
        shared, pos = _get_varint(buf, pos)
        slen, pos = _get_varint(buf, pos)
        t = prev[:shared] + buf[pos : pos + slen]
        pos += slen
        if t == term:
            return ordinal
        if t > term:
            return -1
        prev = t
        ordinal += 1
    return -1
