# Copy of trinity_tpu/index/builder.py; only its imports name the port.
"""Segment builder — the indexing session.

API analog of the reference's SegmentIndexSession (indexer.h:30-225):
``begin(docid)`` returns a document proxy, ``proxy.insert(term, pos,
payload)`` buffers hits (indexer.cpp:14-31), ``insert/update/erase`` commit a
document, and ``commit()`` produces a block-aligned SegmentData. The
reference's commit pipeline — scan intermediate state into (term, doc, hits)
tuples, partitioned parallel sort, per-term encoder replay
(indexer.cpp:311-564) — becomes vectorized numpy: one stable lexsort over
(term, local-doc) keys and grouped slicing, emitting bit-plane blocks.
"""

from __future__ import annotations

import os

import numpy as np

from trinity_tpu_torch.index.format import (
    PAYLOAD_DT,
    FieldStatistics,
    SegmentData,
    pack_payloads,
)
from trinity_tpu_torch.limits import (
    BLOCK_SIZE,
    MAX_FREQ_BITS,
    MAX_POSITION,
    MAX_TERM_LENGTH,
)
from trinity_tpu_torch.utils.bitpack import bit_width, pack_plane_matrix, plane_rows


class DocumentProxy:
    """Buffers one document's hits (document_proxy, indexer.h:99-149)."""

    __slots__ = ("doc_id", "hits", "_session")

    def __init__(self, session, doc_id: int):
        self._session = session
        self.doc_id = doc_id
        self.hits = []  # (term_id, position, payload_val, payload_len)

    def insert(self, term, position: int, payload=0, payload_len=None) -> None:
        """payload: int (u64) or bytes (<= 8, the Encoder payload-span form,
        codecs.h:176-200). payload_len defaults to len(bytes), else 8 for a
        nonzero int, else 0 — the term_hit.payloadLen field (runtime.h:8-20)."""
        if position >= MAX_POSITION:
            raise ValueError(f"position {position} >= MaxPosition {MAX_POSITION}")
        if isinstance(payload, (bytes, bytearray)):
            if len(payload) > 8:
                raise ValueError(f"payload {len(payload)} bytes > 8")
            if payload_len is None:
                payload_len = len(payload)
            payload = int.from_bytes(payload, "little")
        if payload_len is None:
            payload_len = 8 if payload else 0
        if not 0 <= payload_len <= 8:
            raise ValueError(f"payload_len {payload_len} not in [0, 8]")
        tid = self._session._intern(term)
        self.hits.append((tid, position, payload, payload_len))


class SegmentIndexSession:
    """Builds one segment from documents (indexer.h:30, indexer.cpp:311-564)."""

    def __init__(
        self,
        track_payloads: bool = False,
        spill_threshold: int | None = None,
        spill_dir: str | None = None,
    ):
        self._terms: dict = {}  # bytes -> intern id (session-local, indexer.cpp:161-185)
        self._term_list: list = []
        self._docs: dict = {}  # app docid -> list[(intern tid, pos, payload)]
        self._seen: set = set()  # all committed doc ids (duplicate guard)
        self._updated: set = set()
        self.track_payloads = track_payloads
        # bounded-memory indexing (intermediateStateFlushFreq analog,
        # indexer.cpp:134-152): once the buffered hit count crosses the
        # threshold, the in-memory document buffer is flushed to a temp
        # spill file; commit() concatenates spills + live buffer, so RAM is
        # bounded by the spill threshold instead of the corpus size
        self.spill_threshold = spill_threshold
        self._spill_dir = spill_dir
        self._spills: list = []
        self._flat_batches: list = []  # bulk_index_ids pre-flattened hits
        self._pending_hits = 0

    # ----------------------------------------------------------- interning
    def _intern(self, term) -> int:
        if isinstance(term, str):
            term = term.encode("utf-8")
        if not term or len(term) > MAX_TERM_LENGTH:
            raise ValueError(f"bad term length {len(term)}")
        tid = self._terms.get(term)
        if tid is None:
            tid = len(self._term_list)
            self._terms[term] = tid
            self._term_list.append(term)
        return tid

    # ----------------------------------------------------------- documents
    def begin(self, doc_id: int) -> DocumentProxy:
        return DocumentProxy(self, doc_id)

    def insert(self, proxy: DocumentProxy) -> None:
        """Index a new document (indexer.h:192-198)."""
        self._commit_document(proxy)

    def update(self, proxy: DocumentProxy) -> None:
        """Index + shadow older copies in older segments (indexer.h:199-205)."""
        self._commit_document(proxy)
        self._updated.add(proxy.doc_id)

    def erase(self, doc_id: int) -> None:
        """Only shadow older copies (indexer.cpp:224-227)."""
        self._updated.add(doc_id)

    def _commit_document(self, proxy: DocumentProxy) -> None:
        if proxy.doc_id in self._seen:
            # duplicate-doc guard (indexer.cpp:187-222)
            raise ValueError(f"document {proxy.doc_id} committed twice")
        self._seen.add(proxy.doc_id)
        self._docs[proxy.doc_id] = proxy.hits
        self._pending_hits += len(proxy.hits)
        self._maybe_spill()

    def _maybe_spill(self) -> None:
        if (
            self.spill_threshold is not None
            and self._pending_hits >= self.spill_threshold
        ):
            self.flush_intermediate()

    def flush_intermediate(self) -> None:
        """Spill the buffered documents to a temp file (the reference's
        intermediate-state flush, indexer.cpp:134-152). Safe to call any
        time; commit() merges every spill."""
        if not self._docs and not self._flat_batches:
            return
        import tempfile

        tid_a, doc_a, pos_a, pay_a = self._flatten_pending()
        fd, path = tempfile.mkstemp(
            suffix=".trinity-spill.npz", dir=self._spill_dir
        )
        with os.fdopen(fd, "wb") as f:
            arrays = {"tid": tid_a, "doc": doc_a, "pos": pos_a}
            if pay_a is not None:
                arrays["pay"] = pay_a
            np.savez(f, **arrays)
        self._spills.append(path)
        self._docs.clear()
        self._flat_batches.clear()
        self._pending_hits = 0

    def _flatten_pending(self):
        """Flatten the buffered docs into flat hit arrays with APP doc ids
        (local ids are assigned at commit, after all spills are known)."""

        def nhits(h):
            return len(h[0]) if isinstance(h, tuple) else len(h)

        total = sum(nhits(h) for h in self._docs.values()) + sum(
            len(b[0]) for b in self._flat_batches
        )
        tid_a = np.empty(total, np.int64)
        doc_a = np.empty(total, np.int64)
        pos_a = np.empty(total, np.int64)
        pay_a = np.zeros(total, PAYLOAD_DT) if self.track_payloads else None
        o = 0
        for app_id, hits in self._docs.items():
            if isinstance(hits, tuple):  # bulk_index array fast path
                n = len(hits[0])
                tid_a[o : o + n] = hits[0]
                doc_a[o : o + n] = app_id
                pos_a[o : o + n] = hits[1]
                if pay_a is not None and hits[2] is not None:
                    pay_a[o : o + n] = hits[2]
                o += n
                continue
            for t, pp, pl, pln in hits:
                tid_a[o] = t
                doc_a[o] = app_id
                pos_a[o] = pp
                if pay_a is not None:
                    pay_a[o] = (pl, pln)
                o += 1
        for bt, bd, bp, bpay in self._flat_batches:
            n = len(bt)
            tid_a[o : o + n] = bt
            doc_a[o : o + n] = bd
            pos_a[o : o + n] = bp
            if pay_a is not None and bpay is not None:
                pay_a[o : o + n] = bpay
            o += n
        return tid_a, doc_a, pos_a, pay_a

    def bulk_index(
        self, doc_ids, docs_tokens, first_pos: int = 1, payloads=None,
        payload_lens=None,
    ) -> None:
        """Vectorized batch ingestion: one np.unique interning pass over the
        whole batch instead of per-token dict lookups — the bulk analog of
        the reference's buffered commit pipeline (indexer.cpp:311-420).
        docs_tokens: sequence of token lists, positions assigned
        first_pos..len (token-parser output order). payloads: optional
        per-doc sequences of u64 hit payloads aligned to the tokens, with
        optional parallel payload_lens (term_hit.payload/payloadLen,
        runtime.h:8-20; lens default 8 for nonzero values); requires
        track_payloads."""
        if payloads is not None and not self.track_payloads:
            raise ValueError("payloads require track_payloads=True")
        docs_tokens = list(docs_tokens)
        max_len = max((len(t) for t in docs_tokens), default=0)
        if max_len and first_pos + max_len - 1 >= MAX_POSITION:
            # same limit DocumentProxy.insert enforces per hit
            raise ValueError(
                f"position {first_pos + max_len - 1} >= MaxPosition {MAX_POSITION}"
            )
        flat = [t for toks in docs_tokens for t in toks]
        if not flat:
            for d in doc_ids:
                self._commit_document(DocumentProxy(self, int(d)))
            return
        uniq, inv = np.unique(np.asarray(flat, dtype=object), return_inverse=True)
        base = np.asarray([self._intern(t) for t in uniq.tolist()], np.int64)
        tids = base[inv]
        o = 0
        for di, (d, toks) in enumerate(zip(doc_ids, docs_tokens)):
            n = len(toks)
            d = int(d)
            if d in self._seen:
                raise ValueError(f"document {d} committed twice")
            self._seen.add(d)
            # bulk documents store hits as arrays (fast path in commit)
            self._docs[d] = (
                tids[o : o + n],
                np.arange(first_pos, first_pos + n, dtype=np.int64),
                pack_payloads(
                    payloads[di],
                    payload_lens[di] if payload_lens is not None else None,
                )
                if payloads is not None
                else None,
            )
            self._pending_hits += n
            o += n
        self._maybe_spill()

    def bulk_index_ids(
        self,
        doc_ids,
        token_ids,
        doc_bounds,
        id_to_term,
        first_pos: int = 1,
        payloads=None,
        payload_lens=None,
    ) -> None:
        """Fully vectorized ingestion of a pre-tokenized integer stream —
        the large-corpus analog of the reference's buffered commit pipeline
        (indexer.cpp:311-420) for callers that already hold token ids.

        doc_ids: (D,) app doc ids. token_ids: (N,) ints indexing
        id_to_term. doc_bounds: (D+1,) prefix offsets — doc d's tokens are
        token_ids[doc_bounds[d]:doc_bounds[d+1]], positions assigned
        first_pos.. in stream order. id_to_term: sequence mapping token id
        -> term text; only ids that actually appear are interned, so the
        committed segment is identical to the equivalent bulk_index call.
        payloads: optional (N,) u64 per-hit payloads, payload_lens optional
        (N,) u8 lengths (requires track_payloads)."""
        if payloads is not None and not self.track_payloads:
            raise ValueError("payloads require track_payloads=True")
        doc_ids = np.asarray(doc_ids, np.int64)
        token_ids = np.asarray(token_ids, np.int64)
        doc_bounds = np.asarray(doc_bounds, np.int64)
        if len(doc_bounds) != len(doc_ids) + 1 or doc_bounds[-1] != len(
            token_ids
        ):
            raise ValueError("doc_bounds must be a (D+1,) prefix over token_ids")
        lengths = np.diff(doc_bounds)
        max_len = int(lengths.max()) if len(lengths) else 0
        if max_len and first_pos + max_len - 1 >= MAX_POSITION:
            raise ValueError(
                f"position {first_pos + max_len - 1} >= MaxPosition {MAX_POSITION}"
            )
        dup = self._seen.intersection(doc_ids.tolist())
        if dup:
            raise ValueError(f"document {next(iter(dup))} committed twice")
        self._seen.update(int(d) for d in doc_ids)
        n = len(token_ids)
        if n == 0:
            return
        present = np.unique(token_ids)
        remap = np.full(int(present.max()) + 1, -1, np.int64)
        remap[present] = [self._intern(id_to_term[int(i)]) for i in present]
        tid_a = remap[token_ids]
        doc_a = np.repeat(doc_ids, lengths)
        pos_a = (
            np.arange(n, dtype=np.int64)
            - np.repeat(doc_bounds[:-1], lengths)
            + first_pos
        )
        pay_a = (
            pack_payloads(payloads, payload_lens)
            if payloads is not None
            else None
        )
        self._flat_batches.append((tid_a, doc_a, pos_a, pay_a))
        self._pending_hits += n
        self._maybe_spill()

    # -------------------------------------------------------------- commit
    def commit(self) -> SegmentData:
        app_ids = np.array(sorted(self._seen), dtype=np.uint32)
        n_docs = len(app_ids)

        if self._spills:
            # spill files exist -> the corpus outgrew the memory budget, so
            # the output must be encoded in bounded partitions too
            return self._commit_partitioned(app_ids, n_docs)

        # flatten the live buffer (app doc ids throughout)
        parts = [self._flatten_pending()]
        tid_a = np.concatenate([x[0] for x in parts])
        doc_app = np.concatenate([x[1] for x in parts])
        pos_a = np.concatenate([x[2] for x in parts])
        pay_a = (
            np.concatenate(
                [
                    x[3]
                    if x[3] is not None
                    else np.zeros(len(x[0]), PAYLOAD_DT)
                    for x in parts
                ]
            )
            if self.track_payloads
            else None
        )
        total = len(tid_a)
        # app -> dense local ids (one vectorized remap over all hits)
        doc_a = np.searchsorted(app_ids, doc_app).astype(np.int64)

        # sorted term space: intern id -> sorted ordinal (terms_cmp order)
        sorted_terms, rank = self._sorted_terms_rank()
        if total:
            tid_a = rank[tid_a]

        # one lexsort replaces the 32-way partitioned parallel sort
        # (indexer.cpp:395-420): key = (term ordinal, local doc, position)
        if total:
            perm = np.lexsort((pos_a, doc_a, tid_a))
            tid_a, doc_a, pos_a = tid_a[perm], doc_a[perm], pos_a[perm]
            if pay_a is not None:
                pay_a = pay_a[perm]

        return _build_segment(
            app_ids,
            sorted_terms,
            tid_a,
            doc_a,
            pos_a,
            pay_a,
            np.array(sorted(self._updated), dtype=np.uint32),
            n_docs,
        )

    def _sorted_terms_rank(self):
        """(sorted term list, intern-id -> sorted-ordinal map)."""
        order = sorted(
            range(len(self._term_list)), key=lambda i: self._term_list[i]
        )
        sorted_terms = [self._term_list[i] for i in order]
        rank = np.empty(len(order), np.int64)
        rank[order] = np.arange(len(order))
        return sorted_terms, rank

    def _commit_partitioned(self, app_ids, n_docs) -> SegmentData:
        """Bounded-memory commit: encode the index output in TERM PARTITIONS
        instead of concatenating + lexsorting the whole corpus.

        The reference bounds indexing memory on both sides: input hits flush
        at intermediateStateFlushFreq (indexer.cpp:134-152) and the codec
        encoder streams its output through a flushing sink (codecs.h:76-90,
        lucene_codec.cpp:107-120), so peak RAM tracks the flush frequency,
        not the corpus. Here the spill files bound the input; this method
        bounds the ENCODE: pick contiguous sorted-term-ordinal ranges whose
        total hit count fits the spill threshold, and for each range gather
        just its hits from every spill, lexsort that slice, and encode its
        blocks. Per-partition plane matrices are merged with cross-word bit
        shifts, so the output is BIT-IDENTICAL to the monolithic build
        (tests/test_index_builder.py asserts array equality). Raw positions
        stream through a disk memmap; peak RAM is O(partition + output)
        instead of O(3x raw corpus).
        """
        from trinity_tpu_torch.limits import MAX_SEGMENT_DOCS

        if n_docs >= MAX_SEGMENT_DOCS:
            raise ValueError(
                f"segment docid space {n_docs} >= 2^24: packed batch outputs "
                "carry docids as f32 (exact only below 2^24) — shard the "
                "corpus into multiple segments instead"
            )
        self.flush_intermediate()  # everything lives in spills now
        sorted_terms, rank = self._sorted_terms_rank()
        n_terms = len(sorted_terms)

        # metadata pass: hits per sorted ordinal (each spill loaded alone)
        hits_per = np.zeros(max(n_terms, 1), np.int64)
        for path in self._spills:
            z = np.load(path)
            if len(z["tid"]):
                hits_per[: n_terms] += np.bincount(
                    rank[z["tid"]], minlength=n_terms
                )
        total = int(hits_per.sum())

        # contiguous ordinal partitions bounded by the spill threshold (a
        # single term's postings can exceed it — then it gets its own
        # partition; the encoder needs a term's postings together)
        budget = max(
            self.spill_threshold or max(total, 1),
            int(hits_per.max(initial=1)),
        )
        cuts, acc = [0], 0
        for t in range(n_terms):
            if acc + hits_per[t] > budget and acc:
                cuts.append(t)
                acc = 0
            acc += int(hits_per[t])
        cuts.append(n_terms)

        # the corpus-sized scratch memmaps must not outlive a failed
        # commit (repeated failures would fill the spill dir); spills
        # themselves are session state and only removed on success
        enc = _PartitionEncoder(
            n_terms, total, n_docs, self.track_payloads, self._spill_dir
        )
        try:
            for lo, hi in zip(cuts[:-1], cuts[1:]):
                parts_t, parts_d, parts_p, parts_pl = [], [], [], []
                for path in self._spills:
                    z = np.load(path)
                    if not len(z["tid"]):
                        continue
                    r = rank[z["tid"]]
                    sel = (r >= lo) & (r < hi)
                    if not sel.any():
                        continue
                    parts_t.append(r[sel])
                    parts_d.append(z["doc"][sel])
                    parts_p.append(z["pos"][sel])
                    if self.track_payloads:
                        parts_pl.append(
                            z["pay"][sel]
                            if "pay" in z.files
                            else np.zeros(int(sel.sum()), PAYLOAD_DT)
                        )
                if not parts_t:
                    continue
                tid_a = np.concatenate(parts_t)
                doc_a = np.searchsorted(app_ids, np.concatenate(parts_d)).astype(
                    np.int64
                )
                pos_a = np.concatenate(parts_p)
                perm = np.lexsort((pos_a, doc_a, tid_a))
                tid_a, doc_a, pos_a = tid_a[perm], doc_a[perm], pos_a[perm]
                pay_a = (
                    np.concatenate(parts_pl)[perm] if self.track_payloads else None
                )
                enc.add(lo, hi, tid_a, doc_a, pos_a, pay_a)

            for path in self._spills:
                os.unlink(path)
            self._spills.clear()

            return enc.finish(
                app_ids,
                sorted_terms,
                np.array(sorted(self._updated), dtype=np.uint32),
            )
        finally:
            enc.close()


def _positions_distinct(tid_a, doc_a, pos_a) -> bool:
    """True when no (term, doc, position) triple repeats in the LEXSORTED
    hit stream (duplicates are adjacent after the commit lexsort). Gates
    the dense positional-bitmask phrase path (format.py field doc)."""
    if len(tid_a) < 2:
        return True
    return not bool(
        np.any(
            (tid_a[1:] == tid_a[:-1])
            & (doc_a[1:] == doc_a[:-1])
            & (pos_a[1:] == pos_a[:-1])
        )
    )


def _posting_runs(tid_a, doc_a, n_docs):
    """Grouped (term, doc) run boundaries over lexsorted hit streams ->
    (p_start, p_tid, p_doc, p_freq) — shared by the monolithic and
    partitioned commits (their outputs must stay bit-identical). Raises on
    freq >= 2^16: it would wrap the uint16 block_max_freq WAND bound to 0
    (dropping true top-k docs in search_pruned) and overflow the device
    verifier's fcap sizing."""
    n = len(tid_a)
    if not n:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    key = tid_a * (n_docs + 1) + doc_a
    boundaries = np.empty(n, bool)
    boundaries[0] = True
    np.not_equal(key[1:], key[:-1], out=boundaries[1:])
    p_start = np.flatnonzero(boundaries)
    p_freq = np.diff(np.append(p_start, n))
    if int(p_freq.max()) >= (1 << MAX_FREQ_BITS):
        raise ValueError("per-document term frequency must be < 2^16")
    return p_start, tid_a[p_start], doc_a[p_start], p_freq


class _PartitionEncoder:
    """Bounded-memory segment assembly from term-ordinal partitions.

    Callers feed contiguous sorted-term-ordinal ranges via add() — each a
    lexsorted (term, doc, pos) hit slice covering ALL hits of its terms —
    and finish() assembles a SegmentData bit-identical to the monolithic
    _build_segment over the concatenated stream (tests assert array
    equality). Per-partition plane matrices merge with cross-word bit
    shifts; raw positions stream through a disk memmap, so peak RAM is
    O(one partition + compressed output), not O(corpus). Shared by
    Builder._commit_partitioned (input: spill files) and
    merge.MergeCandidatesCollection.merge_partitioned (input: per-source
    block-range decodes) — the streaming analog of the reference's flushing
    encoder sink (codecs.h:76-90) and codec-native participant merge
    cursors (lucene_codec.cpp:963-1393).
    """

    def __init__(self, n_terms, total_hits, n_docs, track_payloads,
                 spill_dir=None):
        import tempfile

        self.n_terms = n_terms
        self.n_docs = n_docs
        self.term_df = np.zeros(n_terms, np.uint32)
        self.term_sum_hits = np.zeros(n_terms, np.uint64)
        self.term_nblocks = np.zeros(n_terms, np.int64)
        self._blk_parts = []  # per-partition block-array tuples
        self._plane_parts = []  # merged u32 word-rows (_append_planes)
        self._prow_total = 0  # exact plane rows emitted so far
        self._n_postings_total = 0
        self._hit_base = 0
        self._max_pos = 0
        self._pos_distinct = True
        fd, self._pos_path = tempfile.mkstemp(
            suffix=".trinity-pos.u32", dir=spill_dir
        )
        os.close(fd)
        # total_hits may be an upper bound (merge feeds masked-filtered
        # hits); finish() slices by the exact count written
        self._pos_mm = np.lib.format.open_memmap(
            self._pos_path, mode="w+", dtype=np.uint32,
            shape=(max(total_hits, 1),),
        )
        self._pay_mm = None
        self._pay_path = None
        if track_payloads:
            fd, self._pay_path = tempfile.mkstemp(
                suffix=".trinity-pay.u64", dir=spill_dir
            )
            os.close(fd)
            self._pay_mm = np.lib.format.open_memmap(
                self._pay_path, mode="w+", dtype=PAYLOAD_DT,
                shape=(max(total_hits, 1),),
            )

    def _append_planes(self, words, p_local):
        """Merge a partition's packed planes at plane-row offset
        _prow_total (not word-aligned): shift by `lead` bits with carry
        across word rows, OR the first row into the previous tail."""
        if p_local == 0:
            return
        lead = self._prow_total % 32
        if lead == 0:
            self._plane_parts.append(words.copy())
        else:
            lw = words.astype(np.uint64) << np.uint64(lead)
            R = len(words)
            ext = np.zeros((R + 1, BLOCK_SIZE), np.uint32)
            ext[:R] = (lw & 0xFFFFFFFF).astype(np.uint32)
            ext[1:] |= (lw >> np.uint64(32)).astype(np.uint32)
            need = -(-(lead + p_local) // 32)
            self._plane_parts[-1][-1] |= ext[0]
            if need > 1:
                self._plane_parts.append(ext[1:need])
        self._prow_total += p_local

    def add(self, lo, hi, tid_a, doc_a, pos_a, pay_a=None):
        """Encode one partition: term ordinals in [lo, hi) (GLOBAL sorted
        ordinals), streams lexsorted by (term, doc, pos), covering every
        hit of those terms. Partitions must arrive in ascending order."""
        n = len(tid_a)
        if not n:
            return
        p_start, p_tid, p_doc, p_freq = _posting_runs(
            tid_a, doc_a, self.n_docs
        )
        p_tid = p_tid - lo  # partition-local term index

        nt = hi - lo
        df = np.bincount(p_tid, minlength=nt)
        self.term_df[lo:hi] = df
        self.term_sum_hits[lo:hi] = np.bincount(
            p_tid, weights=p_freq, minlength=nt
        ).astype(np.uint64)
        nb = -(-df // BLOCK_SIZE)
        self.term_nblocks[lo:hi] = nb
        nbl = int(nb.sum())
        posting_start = np.zeros(nt + 1, np.int64)
        posting_start[:-1] = np.searchsorted(p_tid, np.arange(nt))
        posting_start[-1] = len(p_tid)
        p_start_global = (p_start + self._hit_base).astype(np.uint32)

        tbs = np.zeros(nt, np.int64)
        if nt > 1:
            tbs[1:] = np.cumsum(nb[:-1])
        out = _encode_blocks(
            posting_start, p_doc, p_freq, p_start_global, nt, nbl, tbs
        )
        (bpo, bfd, bld, bct, bbd, bbf, bho, bmf, words) = out
        p_local = int(bbd.astype(np.int64).sum() + bbf.astype(np.int64).sum())
        self._blk_parts.append(
            (bpo.astype(np.int64) + self._prow_total,
             bfd, bld, bct, bbd, bbf, bho, bmf)
        )
        self._append_planes(words, p_local)
        self._n_postings_total += len(p_tid)
        self._pos_mm[self._hit_base : self._hit_base + n] = pos_a
        if self._pay_mm is not None:
            self._pay_mm[self._hit_base : self._hit_base + n] = (
                pay_a if pay_a is not None else np.zeros(n, PAYLOAD_DT)
            )
        self._hit_base += n
        self._max_pos = max(self._max_pos, int(pos_a.max()))
        # partitions are whole-term ranges, so (term, doc) runs never
        # straddle partitions: AND of per-partition checks equals the
        # monolithic check
        self._pos_distinct = self._pos_distinct and _positions_distinct(
            tid_a, doc_a, pos_a
        )

    def finish(self, app_ids, sorted_terms, updated) -> SegmentData:
        from trinity_tpu_torch.utils import native
        from trinity_tpu_torch.utils.bitpack import pack_value_groups

        n_terms = self.n_terms
        total = self._hit_base
        term_block_start = np.zeros(n_terms, np.int64)
        if n_terms > 1:
            term_block_start[1:] = np.cumsum(self.term_nblocks[:-1])
        if self._blk_parts:
            block_arrays = [np.concatenate(x) for x in zip(*self._blk_parts)]
        else:
            block_arrays = [
                np.zeros(0, d)
                for d in (
                    np.int64, np.uint32, np.uint32, np.int32,
                    np.uint8, np.uint8, np.uint32, np.uint16,
                )
            ]
        (bpo, bfd, bld, bct, bbd, bbf, bho, bmf) = block_arrays
        planes = (
            np.vstack(self._plane_parts)
            if self._plane_parts
            else np.zeros((0, BLOCK_SIZE), np.uint32)
        )

        pos_view = self._pos_mm[:total]
        packed_pos = native.pack_value_groups(pos_view)
        if packed_pos is None:
            packed_pos = pack_value_groups(pos_view)
        hit_planes, hit_group_off = packed_pos
        payloads = (
            np.asarray(self._pay_mm[:total])
            if self._pay_mm is not None
            else None
        )

        stats = FieldStatistics(
            sum_term_hits=total,
            total_terms=n_terms,
            sum_terms_docs=self._n_postings_total,
            docs_cnt=self.n_docs,
        )
        return SegmentData(
            doc_map=app_ids,
            terms=sorted_terms,
            term_block_start=term_block_start.astype(np.uint32),
            term_nblocks=self.term_nblocks.astype(np.uint32),
            term_df=self.term_df,
            term_sum_hits=self.term_sum_hits.astype(np.uint32),
            block_plane_off=bpo.astype(np.uint32),
            block_first_doc=bfd,
            block_last_doc=bld,
            block_count=bct,
            block_bits_doc=bbd,
            block_bits_freq=bbf,
            block_hits_off=bho,
            block_max_freq=bmf,
            planes=planes,
            hit_planes=hit_planes,
            hit_group_off=hit_group_off,
            payloads=payloads,
            updated_ids=updated,
            stats=stats,
            max_position=self._max_pos,
            positions_distinct=self._pos_distinct,
        )

    def close(self):
        """Drop + unlink the scratch memmaps (idempotent)."""
        self._pos_mm = None
        if self._pos_path is not None:
            try:
                os.unlink(self._pos_path)
            except OSError:
                pass
            self._pos_path = None
        self._pay_mm = None
        if self._pay_path is not None:
            try:
                os.unlink(self._pay_path)
            except OSError:
                pass
            self._pay_path = None


def _encode_blocks(
    posting_start, p_doc, p_freq, hits_off, n_terms, n_blocks, term_block_start
):
    """Block encode: native hot loop when libtrinity_host is built (the
    reference's encode phase is ~69% of indexing time, indexer.cpp:302-310),
    numpy otherwise. Returns the 8 block arrays + plane words."""
    from trinity_tpu_torch.utils import native

    out = (
        native.build_blocks(
            posting_start,
            p_doc.astype(np.uint32),
            p_freq.astype(np.uint32),
            hits_off.astype(np.uint32),
            n_blocks,
        )
        if n_blocks
        else None
    )
    if out is None:
        out = _build_blocks_numpy(
            posting_start, p_doc, p_freq, hits_off, n_terms, n_blocks,
            term_block_start,
        )
    return out


def _build_segment(
    app_ids, sorted_terms, tid_a, doc_a, pos_a, pay_a, updated, n_docs
) -> SegmentData:
    """Encoder replay (indexer.cpp:429-480) vectorized: grouped (term, doc)
    runs -> freqs; per-term 128-doc blocks -> bit planes."""
    from trinity_tpu_torch.limits import MAX_SEGMENT_DOCS

    if n_docs >= MAX_SEGMENT_DOCS:
        raise ValueError(
            f"segment docid space {n_docs} >= 2^24: packed batch outputs "
            "carry docids as f32 (exact only below 2^24) — shard the corpus "
            "into multiple segments (parallel.mesh.split_segment) instead"
        )
    n_terms = len(sorted_terms)
    total = len(tid_a)

    # unique (term, doc) postings and their freqs
    p_start, p_tid, p_doc, p_freq = _posting_runs(tid_a, doc_a, n_docs)

    n_postings = len(p_tid)
    term_df = np.bincount(p_tid, minlength=n_terms).astype(np.uint32)
    term_sum_hits = (
        np.bincount(p_tid, weights=p_freq, minlength=n_terms).astype(np.uint64)
        if n_postings
        else np.zeros(n_terms, np.uint64)
    )

    # block layout
    term_nblocks = -(-term_df.astype(np.int64) // BLOCK_SIZE)
    term_block_start = np.zeros(n_terms, np.int64)
    if n_terms > 1:
        term_block_start[1:] = np.cumsum(term_nblocks[:-1])
    n_blocks = int(term_nblocks.sum())

    posting_start = np.zeros(n_terms + 1, np.int64)
    posting_start[:-1] = np.searchsorted(p_tid, np.arange(n_terms))
    posting_start[-1] = n_postings

    # hits offset per posting = start index into pos_a (positions already
    # grouped by the lexsort); the encode hot loop runs natively when
    # libtrinity_host is built (the reference's encode phase is ~69% of
    # indexing time, indexer.cpp:302-310)
    (
        block_plane_off,
        block_first_doc,
        block_last_doc,
        block_count,
        block_bits_doc,
        block_bits_freq,
        block_hits_off,
        block_max_freq,
        planes,
    ) = _encode_blocks(
        posting_start, p_doc, p_freq, p_start, n_terms, n_blocks,
        term_block_start,
    )

    from trinity_tpu_torch.utils import native as _native
    from trinity_tpu_torch.utils.bitpack import pack_value_groups

    pos_u32 = pos_a.astype(np.uint32)
    packed_pos = _native.pack_value_groups(pos_u32)
    if packed_pos is None:
        packed_pos = pack_value_groups(pos_u32)
    hit_planes, hit_group_off = packed_pos

    stats = FieldStatistics(
        sum_term_hits=int(total),
        total_terms=n_terms,
        sum_terms_docs=int(n_postings),
        docs_cnt=n_docs,
    )
    return SegmentData(
        doc_map=app_ids,
        terms=sorted_terms,
        term_block_start=term_block_start.astype(np.uint32),
        term_nblocks=term_nblocks.astype(np.uint32),
        term_df=term_df,
        term_sum_hits=term_sum_hits.astype(np.uint32),
        block_plane_off=block_plane_off,
        block_first_doc=block_first_doc,
        block_last_doc=block_last_doc,
        block_count=block_count,
        block_bits_doc=block_bits_doc,
        block_bits_freq=block_bits_freq,
        block_hits_off=block_hits_off,
        block_max_freq=block_max_freq,
        planes=planes,
        hit_planes=hit_planes,
        hit_group_off=hit_group_off,
        payloads=pay_a if pay_a is not None else None,
        updated_ids=updated,
        stats=stats,
        max_position=int(pos_a.max(initial=0)),
        positions_distinct=_positions_distinct(tid_a, doc_a, pos_a),
    )


def _build_blocks_numpy(
    posting_start, p_doc, p_freq, p_start, n_terms, n_blocks, term_block_start
):
    """Pure-numpy encode fallback (same contract as native.build_blocks)."""
    block_plane_off = np.zeros(n_blocks, np.uint32)
    block_first_doc = np.zeros(n_blocks, np.uint32)
    block_last_doc = np.zeros(n_blocks, np.uint32)
    block_count = np.zeros(n_blocks, np.int32)
    block_bits_doc = np.zeros(n_blocks, np.uint8)
    block_bits_freq = np.zeros(n_blocks, np.uint8)
    block_hits_off = np.zeros(n_blocks, np.uint32)
    block_max_freq = np.zeros(n_blocks, np.uint16)
    plane_parts = []
    plane_off = 0
    for t in range(n_terms):
        ps, pe = int(posting_start[t]), int(posting_start[t + 1])
        b0 = int(term_block_start[t])
        for bi, off in enumerate(range(ps, pe, BLOCK_SIZE)):
            b = b0 + bi
            sl = slice(off, min(off + BLOCK_SIZE, pe))
            docs = p_doc[sl]
            freqs = p_freq[sl]
            deltas = np.empty(len(docs), np.uint32)
            deltas[0] = 0
            np.subtract(docs[1:], docs[:-1], out=deltas[1:], casting="unsafe")
            bd = bit_width(int(deltas.max(initial=0)))
            f1 = (freqs - 1).astype(np.uint32)
            bf = bit_width(int(f1.max(initial=0)))
            plane_parts.append(plane_rows(deltas, bd))
            plane_parts.append(plane_rows(f1, bf))
            block_plane_off[b] = plane_off
            block_first_doc[b] = docs[0]
            block_last_doc[b] = docs[-1]
            block_count[b] = len(docs)
            block_bits_doc[b] = bd
            block_bits_freq[b] = bf
            block_hits_off[b] = p_start[off]
            block_max_freq[b] = freqs.max()
            plane_off += bd + bf
    all_rows = (
        np.concatenate(plane_parts)
        if plane_parts
        else np.zeros((0, BLOCK_SIZE), np.uint32)
    )
    planes = pack_plane_matrix(all_rows)
    return (
        block_plane_off,
        block_first_doc,
        block_last_doc,
        block_count,
        block_bits_doc,
        block_bits_freq,
        block_hits_off,
        block_max_freq,
        planes,
    )
