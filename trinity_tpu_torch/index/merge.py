# Copy of trinity_tpu/index/merge.py; only its imports name the port.
"""Segment merge / compaction.

The analog of merge.h / merge.cpp: a MergeCandidatesCollection gathers
generation-sorted segments, builds per-source masked registries from the
updated ids of newer candidates (merge.cpp:6-35), and merges them into one
segment, dropping masked documents. Where the reference dispatches between
raw chunk copy / codec-native merge / decode-reencode (merge.cpp:160-394),
the array format here makes one vectorized decode -> filter -> re-encode
pass both the simple and the fast path: postings decode to flat numpy
arrays, survivors are renumbered into the merged dense docid space, and the
standard builder re-blocks them.

Retention planning (consider_tracked_sources, merge.cpp:418-447) is exposed
as `retention_plan`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from trinity_tpu_torch.index.builder import _build_segment
from trinity_tpu_torch.index.format import PAYLOAD_DT, SegmentData, decode_block
from trinity_tpu_torch.index.source import IndexSource


class Retention(enum.Enum):
    """merge.h:80-92."""

    RETAIN_ALL = 0  # keep the source as-is
    RETAIN_UPDATES_ONLY = 1  # only its updated-documents mask still matters
    DELETE = 2  # fully superseded


@dataclass
class MergeCandidate:
    seg: SegmentData
    generation: int


class MergeCandidatesCollection:
    """merge.h:33-93."""

    def __init__(self):
        self.candidates: List[MergeCandidate] = []

    def insert(self, seg: SegmentData, generation: int) -> None:
        self.candidates.append(MergeCandidate(seg, generation))

    def add_source(self, src: IndexSource) -> None:
        self.insert(src.seg, src.generation)

    def commit(self) -> None:
        """Sort newest-first (merge.cpp:6-25)."""
        self.candidates.sort(key=lambda c: -c.generation)

    def _masked_for(self, i: int) -> np.ndarray:
        """Union of updated ids of all *newer* candidates (merge.cpp:26-35)."""
        ids = [c.seg.updated_ids for c in self.candidates[:i] if len(c.seg.updated_ids)]
        return (
            np.unique(np.concatenate(ids)) if ids else np.zeros(0, np.uint32)
        )

    def _plan_survivors(self, keep_updated_ids: bool):
        """Doc-level merge plan, independent of postings size: per-candidate
        survivor masks (newest first; a doc survives if not masked by newer
        candidates' updated ids and not already contributed by a newer
        candidate), the merged app-id space, and the carried updated ids.
        Shared by merge() and merge_partitioned() so both drop exactly the
        same documents (merge.cpp:26-35 masked-registry semantics)."""
        updated_all = np.unique(
            np.concatenate(
                [c.seg.updated_ids for c in self.candidates]
                + [np.zeros(0, np.uint32)]
            )
        )
        updated = (
            updated_all if keep_updated_ids else np.zeros(0, np.uint32)
        )

        survivors = []
        app_id_arrays = []
        seen_app: Optional[np.ndarray] = None
        for i, cand in enumerate(self.candidates):
            seg = cand.seg
            masked_app = self._masked_for(i)
            keep = np.ones(seg.n_docs, bool)
            if len(masked_app):
                idx = np.searchsorted(masked_app, seg.doc_map)
                idx = np.minimum(idx, len(masked_app) - 1)
                keep &= masked_app[idx] != seg.doc_map
            if seen_app is not None and len(seen_app):
                idx = np.searchsorted(seen_app, seg.doc_map)
                idx = np.minimum(idx, len(seen_app) - 1)
                keep &= seen_app[idx] != seg.doc_map
            survivors.append(keep)
            kept_ids = seg.doc_map[keep]
            app_id_arrays.append(kept_ids)
            seen_app = (
                kept_ids
                if seen_app is None
                else np.union1d(seen_app, kept_ids)
            )

        new_app = (
            np.unique(np.concatenate(app_id_arrays))
            if app_id_arrays
            else np.zeros(0, np.uint32)
        )
        return survivors, new_app, updated

    def merge(self, keep_updated_ids: bool = True) -> SegmentData:
        """N-way merge -> one SegmentData (merge.cpp:40-416).

        Fast path: a single candidate with nothing masked is returned
        structurally unchanged (the whole-segment analog of the reference's
        per-term append_index_chunk raw copy, merge.cpp:166-180 — with one
        array layout there is nothing to re-encode).

        Slow path is still one vectorized pass per source: whole-segment
        native decode (format.decode_all_postings), repeat-mask filtering of
        the parallel positions/payloads streams, renumbering into the merged
        docid space, one lexsort, one native re-encode. No per-term or
        per-block Python loops.

        keep_updated_ids: if older segments outside this merge set still
        exist, the merged segment must keep shadowing them; pass False when
        merging the full collection.
        """
        from trinity_tpu_torch.index.format import decode_all_postings

        self.commit()
        survivors, new_app, updated = self._plan_survivors(keep_updated_ids)

        # ---- raw-copy fast path (merge.cpp:166-180 analog) ----
        # a single candidate has no newer in-set candidates, so nothing is
        # masked and nothing needs renumbering: share the arrays as-is
        if len(self.candidates) == 1:
            import copy as _copy

            out = _copy.copy(self.candidates[0].seg)
            out.updated_ids = updated.astype(np.uint32)
            return out

        term_names: set = set()
        for cand in self.candidates:
            term_names.update(cand.seg.terms_list())
        merged_terms = sorted(term_names)
        term_rank = {t: i for i, t in enumerate(merged_terms)}

        all_tid: List[np.ndarray] = []
        all_doc: List[np.ndarray] = []
        all_pos: List[np.ndarray] = []
        all_pay: List[np.ndarray] = []
        any_payloads = any(
            c.seg.payloads is not None for c in self.candidates
        )
        for cand, keep in zip(self.candidates, survivors):
            seg = cand.seg
            if not keep.any():
                continue
            tids, docs, freqs = decode_all_postings(seg)
            # per-hit expansion; positions (and payloads) are parallel to
            # this exact order, so one repeat-mask filters all streams
            hit_doc = np.repeat(docs.astype(np.int64), freqs)
            hit_tid = np.repeat(tids, freqs)
            hit_alive = keep[hit_doc]
            total_hits = len(hit_doc)
            pos = np.asarray(seg.positions[np.flatnonzero(hit_alive)])
            trans = np.searchsorted(new_app, seg.doc_map).astype(np.int64)
            rank_of = np.array(
                [term_rank[t] for t in seg.terms_list()], np.int64
            )
            all_doc.append(trans[hit_doc[hit_alive]])
            all_tid.append(rank_of[hit_tid[hit_alive]])
            all_pos.append(pos.astype(np.int64))
            if any_payloads:
                if seg.payloads is not None:
                    all_pay.append(seg.payloads[: total_hits][hit_alive])
                else:
                    all_pay.append(
                        np.zeros(int(hit_alive.sum()), PAYLOAD_DT)
                    )

        if all_tid:
            tid_a = np.concatenate(all_tid)
            doc_a = np.concatenate(all_doc)
            pos_a = np.concatenate(all_pos)
            pay_a = np.concatenate(all_pay) if any_payloads else None
            perm = np.lexsort((pos_a, doc_a, tid_a))
            tid_a, doc_a, pos_a = tid_a[perm], doc_a[perm], pos_a[perm]
            if pay_a is not None:
                pay_a = pay_a[perm]
        else:
            tid_a = doc_a = pos_a = np.zeros(0, np.int64)
            pay_a = np.zeros(0, PAYLOAD_DT) if any_payloads else None

        merged_term_list = [
            t if isinstance(t, bytes) else t.encode() for t in merged_terms
        ]
        return _build_segment(
            new_app.astype(np.uint32),
            merged_term_list,
            tid_a,
            doc_a,
            pos_a,
            pay_a,
            updated.astype(np.uint32),
            len(new_app),
        )

    def merge_partitioned(
        self,
        keep_updated_ids: bool = True,
        budget_hits: int = 4_000_000,
        spill_dir: Optional[str] = None,
    ) -> SegmentData:
        """Bounded-memory N-way merge: identical output to merge() (tests
        assert array equality), peak RAM O(one term partition + compressed
        output) instead of O(total postings).

        The streaming analog of the reference's codec-native merge, which
        walks per-participant block cursors and bounds RAM at N cursors +
        output (lucene_codec.cpp:963-1393, dispatched merge.cpp:256-287).
        Here the cursor step is a contiguous MERGED-TERM-ordinal range
        whose pre-mask hit total fits `budget_hits`: each source's terms in
        the range form a contiguous source-tid range (both term spaces are
        byte-sorted), so one block-range decode + one contiguous positions
        slice per source feeds the partition, and _PartitionEncoder
        re-blocks it — every pass stays vectorized, no per-term Python
        loop. Raw merged positions stream through a disk memmap
        (builder._commit_partitioned's model).
        """
        from trinity_tpu_torch.index.builder import _PartitionEncoder
        from trinity_tpu_torch.index.format import decode_postings_range
        from trinity_tpu_torch.limits import MAX_SEGMENT_DOCS

        self.commit()
        survivors, new_app, updated = self._plan_survivors(keep_updated_ids)

        if len(self.candidates) == 1:  # raw-copy fast path, as in merge()
            import copy as _copy

            out = _copy.copy(self.candidates[0].seg)
            out.updated_ids = updated.astype(np.uint32)
            return out
        if len(new_app) >= MAX_SEGMENT_DOCS:
            raise ValueError(
                f"merged docid space {len(new_app)} >= 2^24: shard into "
                "multiple segments instead"
            )

        term_names: set = set()
        for cand in self.candidates:
            term_names.update(cand.seg.terms_list())
        merged_terms = sorted(term_names)
        term_rank = {t: i for i, t in enumerate(merged_terms)}
        n_terms = len(merged_terms)

        # per-source: monotone source-tid -> merged-ordinal map, and the
        # local-docid -> merged-local renumbering (doc-level, small)
        s2m = []
        trans = []
        for cand in self.candidates:
            tl = cand.seg.terms_list()
            s2m.append(np.array([term_rank[t] for t in tl], np.int64))
            trans.append(
                np.searchsorted(new_app, cand.seg.doc_map).astype(np.int64)
            )

        # pre-mask hits per merged ordinal: an upper bound on a partition's
        # decode size (masked hits decode, then filter), so cuts bound RAM
        hits_per = np.zeros(max(n_terms, 1), np.int64)
        for cand, m in zip(self.candidates, s2m):
            if len(m):
                np.add.at(
                    hits_per, m, cand.seg.term_sum_hits.astype(np.int64)
                )
        total_ub = int(hits_per.sum())
        budget = max(budget_hits, int(hits_per.max(initial=1)))
        cuts, acc = [0], 0
        for t in range(n_terms):
            if acc + hits_per[t] > budget and acc:
                cuts.append(t)
                acc = 0
            acc += int(hits_per[t])
        cuts.append(n_terms)

        any_payloads = any(
            c.seg.payloads is not None for c in self.candidates
        )
        merged_term_list = [
            t if isinstance(t, bytes) else t.encode() for t in merged_terms
        ]
        enc = _PartitionEncoder(
            n_terms, total_ub, len(new_app), any_payloads, spill_dir
        )
        try:
            for lo, hi in zip(cuts[:-1], cuts[1:]):
                pt, pd, pp, ppl = [], [], [], []
                for cand, keep, m, tr in zip(
                    self.candidates, survivors, s2m, trans
                ):
                    seg = cand.seg
                    if not len(m) or not keep.any():
                        continue
                    slo = int(np.searchsorted(m, lo))
                    shi = int(np.searchsorted(m, hi))
                    if shi <= slo:
                        continue
                    tids, docs, freqs, h0 = decode_postings_range(
                        seg, slo, shi
                    )
                    if not len(docs):
                        continue
                    nh = int(freqs.sum())
                    hit_doc = np.repeat(docs.astype(np.int64), freqs)
                    hit_tid = np.repeat(tids, freqs)
                    alive = keep[hit_doc]
                    if not alive.any():
                        continue
                    pos = np.asarray(seg.positions[h0 : h0 + nh])[alive]
                    pt.append(m[hit_tid[alive]])
                    pd.append(tr[hit_doc[alive]])
                    pp.append(pos.astype(np.uint32))
                    if any_payloads:
                        ppl.append(
                            seg.payloads[h0 : h0 + nh][alive]
                            if seg.payloads is not None
                            else np.zeros(int(alive.sum()), PAYLOAD_DT)
                        )
                if not pt:
                    continue
                tid_a = np.concatenate(pt)
                doc_a = np.concatenate(pd)
                pos_a = np.concatenate(pp)
                pay_a = np.concatenate(ppl) if any_payloads else None
                perm = np.lexsort((pos_a, doc_a, tid_a))
                tid_a, doc_a, pos_a = tid_a[perm], doc_a[perm], pos_a[perm]
                if pay_a is not None:
                    pay_a = pay_a[perm]
                enc.add(lo, hi, tid_a, doc_a, pos_a, pay_a)

            return enc.finish(
                new_app.astype(np.uint32),
                merged_term_list,
                updated.astype(np.uint32),
            )
        finally:
            enc.close()

    def retention_plan(
        self, merged_generations: Sequence[int]
    ) -> Dict[int, Retention]:
        """consider_tracked_sources (merge.cpp:418-447): after merging the
        given generations, what should happen to each tracked source."""
        merged = set(merged_generations)
        newest_merged = max(merged) if merged else -1
        plan: Dict[int, Retention] = {}
        for c in self.candidates:
            if c.generation in merged:
                plan[c.generation] = Retention.DELETE
            elif c.generation < newest_merged:
                # fully shadowed content may still be masked by its updates
                plan[c.generation] = (
                    Retention.RETAIN_UPDATES_ONLY
                    if len(c.seg.updated_ids)
                    else Retention.RETAIN_ALL
                )
            else:
                plan[c.generation] = Retention.RETAIN_ALL
        return plan
