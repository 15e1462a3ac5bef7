# Copy of trinity_tpu/index/format.py; only its imports name the port.
"""Segment format: block-aligned struct-of-arrays postings.

The TPU-native equivalent of the reference's lucene codec segment
(lucene_codec.cpp:163-381: per-term headers, PFor blocks, skiplist entries,
hits stream) re-laid-out as dense HBM-resident arrays so device kernels can
address everything with static shapes:

- docid space is dense ``[0, n_docs)``; ``doc_map`` translates local ->
  application doc ids (the analog of IndexSource::translate_docid,
  index_source.h:100-114).
- each term's postings are split into blocks of <= 128 docs, bit-plane
  packed into the segment-global transposed plane matrix (utils/bitpack.py:
  (ceil(P/32), 128) u32 rows, 32 plane rows per word) so device decode is
  row-aligned DMA + sublane reductions. Per-block skip metadata plays the
  role of the lucene skiplist entry {indexOffset, lastDocID,
  totalHitsSoFar, ...} (lucene_codec.h:128-139) — but lives in flat arrays,
  searchable with vectorized searchsorted instead of branchy binary search
  (lucene_codec.cpp:596-656).
- positions ("hits") are a flat stream addressed by block_hits_off +
  in-block freq prefix sums — the same addressing scheme the reference's
  skiplist fields totalHitsSoFar/curHitsBlockHits enable
  (lucene_codec.h:259-266).

A persisted segment directory is the checkpoint/recovery unit (SURVEY §5.4):
files are written to ``<name>.t`` and renamed, like persist_segment
(indexer.cpp:281-300).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from trinity_tpu_torch.limits import BLOCK_SIZE, WINDOW_SIZE

FORMAT_VERSION = 1
CODEC_NAME = "tpu_planes"

# Per-hit payload: u64 value + u8 length, exactly the reference's term_hit
# {payload, payloadLen} pair (runtime.h:8-20) — applications write <= 8
# payload BYTES per hit (codecs.h:176-200 Encoder payload span) and read
# back both the value and how many bytes were meaningful.
PAYLOAD_DT = np.dtype([("val", "<u8"), ("len", "u1")])


def pack_payloads(vals, lens=None) -> np.ndarray:
    """Build a PAYLOAD_DT array from u64 values (+ optional u8 lengths).
    Without lens, nonzero values default to the full 8 bytes."""
    vals = np.asarray(vals, np.uint64)
    out = np.zeros(len(vals), PAYLOAD_DT)
    out["val"] = vals
    out["len"] = (
        np.asarray(lens, np.uint8)
        if lens is not None
        else np.where(vals != 0, 8, 0).astype(np.uint8)
    )
    return out


def as_payload_array(arr) -> np.ndarray:
    """Coerce a payload stream to PAYLOAD_DT (plain-u64 streams from older
    persisted segments get the default length rule)."""
    arr = np.asarray(arr)
    if arr.dtype == PAYLOAD_DT:
        return arr
    return pack_payloads(arr)


@dataclass
class FieldStatistics:
    """Per-segment stats for scoring (index_source.h:44-53, indexer.cpp:366-473)."""

    sum_term_hits: int = 0  # sum of all term freqs (total hits)
    total_terms: int = 0  # distinct terms
    sum_terms_docs: int = 0  # sum of per-term document frequencies
    docs_cnt: int = 0  # documents in segment

    def to_dict(self):
        return {
            "sumTermHits": self.sum_term_hits,
            "totalTerms": self.total_terms,
            "sumTermsDocs": self.sum_terms_docs,
            "docsCnt": self.docs_cnt,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(d["sumTermHits"], d["totalTerms"], d["sumTermsDocs"], d["docsCnt"])


@dataclass
class SegmentData:
    """In-memory segment: all postings state as flat numpy arrays."""

    # local docid -> application docid, ascending (dense local id space)
    doc_map: np.ndarray  # u32 [n_docs]
    # terms, sorted by byte comparison (terms_cmp, common.h:50-58).
    # None on loaded segments: lookups then go through the packed
    # prefix-compressed dictionary (terms_data/terms_idx) so large
    # vocabularies never materialize as Python lists (terms.cpp:8-103
    # memory model); terms_list() materializes on demand (merge path).
    terms: list | None  # list[bytes], index = term id
    term_block_start: np.ndarray  # u32 [n_terms]
    term_nblocks: np.ndarray  # u32 [n_terms]
    term_df: np.ndarray  # u32 [n_terms] document frequency
    term_sum_hits: np.ndarray  # u32 [n_terms] total freq over docs
    # per-block skip metadata
    block_plane_off: np.ndarray  # u32 [n_blocks] first plane row in `planes`
    block_first_doc: np.ndarray  # u32 [n_blocks] local docid of first posting
    block_last_doc: np.ndarray  # u32 [n_blocks] local docid of last posting
    block_count: np.ndarray  # i32 [n_blocks] postings in block (<= 128)
    block_bits_doc: np.ndarray  # u8 [n_blocks]
    block_bits_freq: np.ndarray  # u8 [n_blocks]
    block_hits_off: np.ndarray  # u32 [n_blocks] offset into positions
    block_max_freq: np.ndarray  # u16 [n_blocks] max freq in block (WAND bound)
    # payload streams
    planes: np.ndarray  # u32 [R, 128] packed plane matrix (bitpack.py)
    hit_planes: np.ndarray  # u32 [R2, 128] plane-packed positions stream
    hit_group_off: np.ndarray  # u32 [ceil(H/128)+1] plane offsets per group
    payloads: np.ndarray | None  # PAYLOAD_DT [total_hits] or None
    # masking & stats
    updated_ids: np.ndarray  # u32 [k] sorted app docids shadowed by this segment
    stats: FieldStatistics = field(default_factory=FieldStatistics)
    # max indexed token position (IndexSource::max_indexed_position analog)
    max_position: int = 0
    # True when no (term, doc) posting holds the same position twice —
    # established at commit from the lexsorted hit stream. Gates the dense
    # positional-bitmask phrase path (ops/posmask.py): a bitmask loses
    # position multiplicity, which only matters when duplicates exist
    # (anchored phrase counts follow member 0's multiplicity,
    # docwordspace.cpp:3-15). False = unknown/has duplicates (older
    # segments load as False and use the candidate ladder).
    positions_distinct: bool = False
    # packed terms dictionary (authoritative on loaded segments)
    terms_data: np.ndarray | None = None
    terms_idx: np.ndarray | None = None
    _n_terms: int = -1  # count when terms is lazy
    _term_cache: dict = field(default_factory=dict, repr=False)

    @property
    def n_docs(self) -> int:
        return len(self.doc_map)

    @property
    def n_terms(self) -> int:
        return len(self.terms) if self.terms is not None else self._n_terms

    @property
    def n_windows(self) -> int:
        return max(1, -(-self.n_docs // WINDOW_SIZE))

    @property
    def positions(self) -> "PositionsView":
        """Random-access view of the plane-packed positions stream
        (materialize_hits addressing, lucene_codec.cpp:767-856)."""
        return PositionsView(self.hit_planes, self.hit_group_off)

    def term_id(self, term) -> int:
        """Exact term lookup -> term id, or -1 (resolve_term_ctx analog).

        Loaded segments resolve through the packed prefix-compressed
        dictionary (terms.cpp:8-103: skiplist binary search + bounded block
        scan) with a hot-term cache — the full term list is never
        materialized on the serve path."""
        if isinstance(term, str):
            term = term.encode("utf-8")
        if self.terms is None:
            tid = self._term_cache.get(term)
            if tid is None:
                from trinity_tpu_torch.index.terms import lookup_term

                tid = lookup_term(self.terms_data, self.terms_idx, term)
                if len(self._term_cache) > 65536:
                    self._term_cache.clear()  # bound the hot cache
                self._term_cache[term] = tid
            return tid
        import bisect

        i = bisect.bisect_left(self.terms, term)
        if i < len(self.terms) and self.terms[i] == term:
            return i
        return -1

    def terms_list(self) -> list:
        """Materialize (and retain) the full term list — cold paths only
        (merge, sharding); the serve path uses term_id over the packed
        dictionary."""
        if self.terms is None:
            from trinity_tpu_torch.index.terms import unpack_terms

            self.terms = unpack_terms(self.terms_data, self.terms_idx)
        return self.terms

    def memory_report(self) -> dict:
        """Index-memory accounting in bytes (the equal-index-memory
        BASELINE constraint): postings planes, positions planes, block/term
        metadata, packed terms dictionary."""
        from trinity_tpu_torch.index.terms import pack_terms

        if self.terms_data is None:
            self.terms_data, self.terms_idx = pack_terms(self.terms)
        meta = sum(
            getattr(self, n).nbytes
            for n in self._ARRAYS
            if n not in ("planes", "hit_planes")
        )
        rep = {
            "postings_planes": int(self.planes.nbytes),
            "positions_planes": int(self.hit_planes.nbytes),
            "block_term_meta": int(meta),
            "terms_dict": int(
                self.terms_data.nbytes + self.terms_idx.nbytes
            ),
        }
        if self.payloads is not None:
            rep["payloads"] = int(self.payloads.nbytes)
        rep["total"] = sum(rep.values())
        return rep

    # ------------------------------------------------------------------ I/O
    _ARRAYS = (
        "doc_map",
        "term_block_start",
        "term_nblocks",
        "term_df",
        "term_sum_hits",
        "block_plane_off",
        "block_first_doc",
        "block_last_doc",
        "block_count",
        "block_bits_doc",
        "block_bits_freq",
        "block_hits_off",
        "block_max_freq",
        "planes",
        "hit_planes",
        "hit_group_off",
        "updated_ids",
    )

    def persist(self, path: str, codec: str = CODEC_NAME) -> None:
        """Write segment to a directory, tmp+rename (indexer.cpp:281-300).

        codec: "tpu_planes" (default — the canonical device layout dumped
        directly) or "gv_streams" (the Google-codec-family alternative,
        index/gvcodec.py: group-varint delta streams, rebuilt through the
        vectorized encoder on load)."""
        if codec != CODEC_NAME:
            if codec != "gv_streams":
                raise ValueError(f"unknown codec {codec!r}")
            from trinity_tpu_torch.index import gvcodec

            gvcodec.persist(self, path)
            return
        os.makedirs(path, exist_ok=True)
        from trinity_tpu_torch.index.terms import pack_terms

        arrays = {name: getattr(self, name) for name in self._ARRAYS}
        if self.payloads is not None:
            arrays["payloads"] = self.payloads
        if self.terms_data is not None:
            tdata, tidx = self.terms_data, self.terms_idx  # already packed
        else:
            tdata, tidx = pack_terms(self.terms)
        arrays["terms_data"] = tdata
        arrays["terms_idx"] = tidx
        tmp = os.path.join(path, "index.npz.t")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(path, "index.npz"))
        manifest = {
            "version": FORMAT_VERSION,
            "codec": CODEC_NAME,
            "stats": self.stats.to_dict(),
            "max_position": self.max_position,
            "positions_distinct": bool(self.positions_distinct),
            "n_docs": self.n_docs,
            "n_terms": self.n_terms,
            "has_payloads": self.payloads is not None,
        }
        tmp = os.path.join(path, "id.t")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(path, "id"))

    @classmethod
    def load(cls, path: str) -> "SegmentData":
        with open(os.path.join(path, "id")) as f:
            manifest = json.load(f)
        if manifest["codec"] != CODEC_NAME:
            if manifest["codec"] == "gv_streams":
                from trinity_tpu_torch.index import gvcodec

                return gvcodec.load(path, manifest)
            raise ValueError(f"unknown codec {manifest['codec']!r}")
        z = np.load(os.path.join(path, "index.npz"))
        kw = {name: z[name] for name in cls._ARRAYS}
        kw["payloads"] = (
            as_payload_array(z["payloads"]) if manifest["has_payloads"] else None
        )
        # terms stay PACKED: lookups go through lookup_term (terms.cpp:8-103)
        kw["terms"] = None
        return cls(
            stats=FieldStatistics.from_dict(manifest["stats"]),
            max_position=manifest["max_position"],
            positions_distinct=bool(manifest.get("positions_distinct", False)),
            terms_data=z["terms_data"],
            terms_idx=z["terms_idx"],
            _n_terms=int(manifest["n_terms"]),
            **kw,
        )


def persisted_size(path: str) -> dict:
    """On-disk footprint of a persisted segment dir, bytes per file +
    total — the measurement behind the codec size/speed tradeoff claim
    (the reference states its Google codec trades size for speed,
    codecs.h:8; here the numbers are recorded, tools/measure_codecs.py)."""
    out = {}
    for fn in sorted(os.listdir(path)):
        fp = os.path.join(path, fn)
        if os.path.isfile(fp):
            out[fn] = os.path.getsize(fp)
    out["total"] = sum(out.values())
    return out


def decode_block(seg: SegmentData, b: int):
    """Host-side reference decode of one block -> (local docids, freqs).

    The numpy oracle for the Pallas kernel in ops/unpack.py; semantics of
    lucene Decoder::unpack_next_block (lucene_codec.cpp:568-594).
    """
    from trinity_tpu_torch.utils.bitpack import unpack_plane_rows, values_from_planes

    off = int(seg.block_plane_off[b])
    cnt = int(seg.block_count[b])
    bd = int(seg.block_bits_doc[b])
    bf = int(seg.block_bits_freq[b])
    deltas = values_from_planes(unpack_plane_rows(seg.planes, off, bd), cnt)
    docs = seg.block_first_doc[b] + np.cumsum(deltas, dtype=np.uint64)
    freqs = (
        values_from_planes(unpack_plane_rows(seg.planes, off + bd, bf), cnt) + 1
    )
    return docs.astype(np.uint32), freqs.astype(np.uint32)


def term_postings(seg: SegmentData, tid: int):
    """All postings of a term -> (local docids, freqs). Host-side oracle."""
    s, n = int(seg.term_block_start[tid]), int(seg.term_nblocks[tid])
    if n == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint32)
    parts = [decode_block(seg, b) for b in range(s, s + n)]
    return (
        np.concatenate([p[0] for p in parts]),
        np.concatenate([p[1] for p in parts]),
    )


def decode_all_postings(seg: SegmentData):
    """Whole-segment decode -> (term ids, local docids, freqs), flat arrays
    in (term, doc) order — one linear pass over the plane matrix (native
    trin_decode_blocks when built, block-loop fallback otherwise). The
    positions stream seg.positions[:freqs.sum()] and the optional payloads
    stream are PARALLEL to this order (the builder lexsorts hits by
    (term, doc, pos)), so merge/compaction can filter hits with one
    repeat-mask. The merge-side analog of the reference's codec-native
    participant cursors (lucene_codec.cpp:963-1393)."""
    from trinity_tpu_torch.config import get_config
    from trinity_tpu_torch.utils import native

    nd = native.decode_blocks(seg) if get_config().use_native else None
    if nd is None:
        n_blocks = len(seg.block_plane_off)
        if n_blocks:
            parts = [decode_block(seg, b) for b in range(n_blocks)]
            docs = np.concatenate([p[0] for p in parts])
            freqs = np.concatenate([p[1] for p in parts])
        else:
            docs = freqs = np.zeros(0, np.uint32)
    else:
        docs, freqs = nd
    tids = np.repeat(
        np.arange(seg.n_terms, dtype=np.int64), seg.term_df.astype(np.int64)
    )
    return tids, docs, freqs


def decode_postings_range(seg: SegmentData, tid_lo: int, tid_hi: int):
    """Decode the contiguous sorted-term range [tid_lo, tid_hi) ->
    (term ids, local docids, freqs, hit_offset): flat arrays in (term, doc)
    order plus the positions-stream offset of the range's first hit, so
    `seg.positions[hit_offset : hit_offset + freqs.sum()]` is the range's
    positions slice. The bounded-memory merge cursor: only this range's
    blocks decode (the role of the reference's per-participant block
    cursors in the codec-native merge, lucene_codec.cpp:963-1393), and
    consecutive ranges tile decode_all_postings exactly."""
    from trinity_tpu_torch.config import get_config
    from trinity_tpu_torch.utils import native

    n_blocks_total = len(seg.block_plane_off)
    nt = seg.n_terms
    b0 = int(seg.term_block_start[tid_lo]) if tid_lo < nt else n_blocks_total
    b1 = int(seg.term_block_start[tid_hi]) if tid_hi < nt else n_blocks_total
    if b1 <= b0:
        z = np.zeros(0, np.uint32)
        return np.zeros(0, np.int64), z, z, 0
    nd = (
        native.decode_blocks_range(seg, b0, b1)
        if get_config().use_native
        else None
    )
    if nd is None:
        parts = [decode_block(seg, b) for b in range(b0, b1)]
        docs = np.concatenate([p[0] for p in parts])
        freqs = np.concatenate([p[1] for p in parts])
    else:
        docs, freqs = nd
    tids = np.repeat(
        np.arange(tid_lo, tid_hi, dtype=np.int64),
        seg.term_df[tid_lo:tid_hi].astype(np.int64),
    )
    return tids, docs, freqs, int(seg.block_hits_off[b0])


def term_positions(seg: SegmentData, tid: int, local_doc: int) -> np.ndarray:
    """Positions of a (term, doc) pair (materialize_hits analog,
    lucene_codec.cpp:767-856)."""
    s, n = int(seg.term_block_start[tid]), int(seg.term_nblocks[tid])
    for b in range(s, s + n):
        docs, freqs = decode_block(seg, b)
        idx = np.searchsorted(docs, local_doc)
        if idx < len(docs) and docs[idx] == local_doc:
            off = int(seg.block_hits_off[b]) + int(freqs[:idx].sum())
            return seg.positions[off : off + int(freqs[idx])]
    return np.zeros(0, np.uint16)


class PositionsView:
    """Random-access decoder over the plane-packed positions stream: supports
    the fancy-indexing the verification paths use (positions[idx_array] and
    contiguous slices), decoding 1-2 groups per access, all vectorized."""

    __slots__ = ("pw", "off")

    def __init__(self, pw: np.ndarray, off: np.ndarray):
        self.pw = pw
        self.off = off

    def __len__(self) -> int:
        return (len(self.off) - 1) * 128 if len(self.off) > 1 else 0

    def __getitem__(self, idx):
        from trinity_tpu_torch.utils.bitpack import unpack_value_groups

        if isinstance(idx, slice):
            start, stop, step = idx.indices(len(self))
            idx = np.arange(start, stop, step)
        return unpack_value_groups(self.pw, self.off, np.asarray(idx))
