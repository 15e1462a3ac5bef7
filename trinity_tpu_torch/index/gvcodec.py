# Copy of trinity_tpu/index/gvcodec.py; only its imports name the port.
"""Alternative persisted codec: group-varint streams ("gv_streams").

The reference ships TWO codec families — the Lucene-style PFor codec and
the Google-style group-varint codec (google_codec.cpp; its own docs call it
larger and slower, codecs.h:8) — selectable per segment. In this framework
the RUNTIME layout is canonical (the transposed plane matrix is what the
device decodes; SURVEY §2.3), so codec variety lives where it still means
something: the persisted form. This module is the Google-codec analog — a
byte-aligned group-varint family for the on-disk streams:

- values encode in groups of 4 with a 1-byte control word (2 bits per
  value = byte length 1..4), control and data bytes in SEPARATE streams so
  decode is branch-free vectorized numpy (a streamvbyte-layout member of
  the group-varint family — the separation is what makes decode
  vectorizable; the reference's interleaved layout would force a
  byte-serial walk);
- doc ids persist as per-term first-docid + deltas, positions as per-run
  first + deltas, doc_map as deltas — all group-varint streams;
- load() decodes the streams and rebuilds the canonical segment through
  the same vectorized encoder the indexer uses (builder._build_segment),
  so a segment round-tripped through either codec is bit-identical to the
  engine.

Like the reference's Google codec, this trades size/speed differently:
byte-aligned groups beat bit-planes only on high-entropy streams, and
load pays a re-encode pass (measured in tests; the manifest records the
codec so collections can mix segments freely).
"""

from __future__ import annotations

import json
import os

import numpy as np

CODEC_NAME = "gv_streams"


# ---------------------------------------------------------------- primitives
def gv_encode(vals: np.ndarray):
    """u32 values -> (control u8[ceil(n/4)], data u8[sum lens])."""
    v = np.ascontiguousarray(vals, np.uint32)
    n = len(v)
    n4 = -(-max(n, 1) // 4) * 4
    vp = np.zeros(n4, np.uint32)
    vp[:n] = v
    lens = np.ones(n4, np.uint8)
    lens[vp >= (1 << 8)] = 2
    lens[vp >= (1 << 16)] = 3
    lens[vp >= (1 << 24)] = 4
    l4 = (lens - 1).reshape(-1, 4)
    ctrl = (
        l4[:, 0] | (l4[:, 1] << 2) | (l4[:, 2] << 4) | (l4[:, 3] << 6)
    ).astype(np.uint8)
    offs = np.zeros(n4, np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    data = np.zeros(int(offs[-1]) + int(lens[-1]), np.uint8)
    for b in range(4):
        m = lens > b
        data[offs[m] + b] = (vp[m] >> (8 * b)).astype(np.uint8)
    return ctrl, data


def gv_decode(ctrl: np.ndarray, data: np.ndarray, n: int) -> np.ndarray:
    """Inverse of gv_encode -> u32[n]."""
    if n == 0:
        return np.zeros(0, np.uint32)
    c = ctrl.astype(np.uint16)
    lens = (
        np.stack([(c >> (2 * i)) & 3 for i in range(4)], axis=1)
        .reshape(-1)
        .astype(np.int64)
        + 1
    )
    offs = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    vals = data[offs].astype(np.uint32)
    for b in range(1, 4):
        m = lens > b
        vals[m] |= data[offs[m] + b].astype(np.uint32) << np.uint32(8 * b)
    return vals[:n]


def _seg_delta(vals: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Per-segment delta encode: within each run of `counts`, first value
    absolute, then successive differences."""
    v = vals.astype(np.int64)
    out = np.empty_like(v)
    if len(v) == 0:
        return out.astype(np.uint32)
    out[0] = v[0]
    out[1:] = v[1:] - v[:-1]
    starts = np.zeros(len(counts), np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    starts = starts[counts > 0]
    out[starts] = v[starts]
    return out.astype(np.uint32)


def _seg_undelta(deltas: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Inverse of _seg_delta (segmented cumulative sum with resets)."""
    d = deltas.astype(np.int64)
    if len(d) == 0:
        return d.astype(np.uint32)
    c = np.cumsum(d)
    starts = np.zeros(len(counts), np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    keep = counts > 0
    starts = starts[keep]
    # value at a segment start must be d[start]; subtract the running sum
    # accumulated before the segment
    base = c[starts] - d[starts]
    out = c - np.repeat(base, counts[keep])
    return out.astype(np.uint32)


# ---------------------------------------------------------------- persist/load
def persist(seg, path: str) -> None:
    """Write `seg` under the gv_streams codec (tmp+fsync+rename, like the
    plane codec — utils.cpp to_file semantics)."""
    from trinity_tpu_torch.index.format import decode_all_postings
    from trinity_tpu_torch.index.terms import pack_terms

    os.makedirs(path, exist_ok=True)
    tids, docs, freqs = decode_all_postings(seg)
    total_hits = int(freqs.sum())
    positions = np.asarray(seg.positions[0:total_hits], np.uint32)
    df = seg.term_df.astype(np.int64)
    streams = {}
    streams["docs_ctrl"], streams["docs_data"] = gv_encode(
        _seg_delta(docs, df)
    )
    streams["freqs_ctrl"], streams["freqs_data"] = gv_encode(
        freqs.astype(np.uint32) - 1
    )
    streams["pos_ctrl"], streams["pos_data"] = gv_encode(
        _seg_delta(positions, freqs.astype(np.int64))
    )
    streams["dmap_ctrl"], streams["dmap_data"] = gv_encode(
        _seg_delta(seg.doc_map, np.array([seg.n_docs], np.int64))
    )
    streams["term_df"] = seg.term_df
    streams["updated_ids"] = seg.updated_ids
    if seg.payloads is not None:
        # Payloads are the family's natural win: canonical dumps the raw
        # PAYLOAD_DT stream (9 B/hit) while apps mostly store 0-2 byte
        # payloads per hit (runtime.h:8-20 term_hit payloadLen) — a
        # byte-aligned group codec stores those near-entropy. u64 values
        # split into lo/hi u32 group-varint streams; lengths ride raw u8.
        pv = seg.payloads["val"]
        lo, hi = gv_encode((pv & np.uint64(0xFFFFFFFF)).astype(np.uint32)), \
            gv_encode((pv >> np.uint64(32)).astype(np.uint32))
        streams["pay_lo_ctrl"], streams["pay_lo_data"] = lo
        streams["pay_hi_ctrl"], streams["pay_hi_data"] = hi
        streams["pay_len"] = seg.payloads["len"]
    if seg.terms_data is not None:
        tdata, tidx = seg.terms_data, seg.terms_idx
    else:
        tdata, tidx = pack_terms(seg.terms)
    streams["terms_data"] = tdata
    streams["terms_idx"] = tidx
    tmp = os.path.join(path, "index.npz.t")
    with open(tmp, "wb") as f:
        np.savez(f, **streams)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, os.path.join(path, "index.npz"))
    manifest = {
        "version": 1,
        "codec": CODEC_NAME,
        "stats": seg.stats.to_dict(),
        "max_position": seg.max_position,
        "n_docs": seg.n_docs,
        "n_terms": seg.n_terms,
        "n_postings": int(len(docs)),
        "total_hits": total_hits,
        "has_payloads": seg.payloads is not None,
    }
    tmp = os.path.join(path, "id.t")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, os.path.join(path, "id"))


def load(path: str, manifest: dict):
    """Decode gv streams and rebuild the canonical segment via the
    indexer's vectorized encoder — the loaded SegmentData is
    engine-identical to one persisted under the plane codec."""
    from trinity_tpu_torch.index.builder import _build_segment
    from trinity_tpu_torch.index.format import FieldStatistics
    from trinity_tpu_torch.index.terms import unpack_terms

    z = np.load(os.path.join(path, "index.npz"))
    n_post = manifest["n_postings"]
    total_hits = manifest["total_hits"]
    df = z["term_df"].astype(np.int64)
    docs = _seg_undelta(
        gv_decode(z["docs_ctrl"], z["docs_data"], n_post), df
    )
    freqs = gv_decode(z["freqs_ctrl"], z["freqs_data"], n_post).astype(
        np.int64
    ) + 1
    positions = _seg_undelta(
        gv_decode(z["pos_ctrl"], z["pos_data"], total_hits), freqs
    )
    doc_map = _seg_undelta(
        gv_decode(z["dmap_ctrl"], z["dmap_data"], manifest["n_docs"]),
        np.array([manifest["n_docs"]], np.int64),
    )
    p_tid = np.repeat(np.arange(len(df), dtype=np.int64), df)
    tid_a = np.repeat(p_tid, freqs)
    doc_a = np.repeat(docs.astype(np.int64), freqs)
    pos_a = positions.astype(np.uint16)
    from trinity_tpu_torch.index.format import as_payload_array

    if not manifest["has_payloads"]:
        pay_a = None
    elif "pay_lo_ctrl" in z:
        n_pay = len(z["pay_len"])
        pv = gv_decode(z["pay_lo_ctrl"], z["pay_lo_data"], n_pay).astype(
            np.uint64
        ) | (
            gv_decode(z["pay_hi_ctrl"], z["pay_hi_data"], n_pay).astype(
                np.uint64
            )
            << np.uint64(32)
        )
        from trinity_tpu_torch.index.format import pack_payloads

        pay_a = pack_payloads(pv, z["pay_len"])
    else:  # older gv segments stored the raw PAYLOAD_DT stream
        pay_a = as_payload_array(z["payloads"])
    terms = unpack_terms(z["terms_data"], z["terms_idx"])
    seg = _build_segment(
        doc_map.astype(np.uint32),
        terms,
        tid_a,
        doc_a,
        pos_a,
        pay_a,
        z["updated_ids"],
        manifest["n_docs"],
    )
    seg.stats = FieldStatistics.from_dict(manifest["stats"])
    seg.max_position = manifest["max_position"]
    seg.terms_data = z["terms_data"]
    seg.terms_idx = z["terms_idx"]
    return seg
