"""Index sources and search-session collections.

Counterpart of ``trinity_tpu/index/source.py`` (the reference's
index_source.h / index_source.cpp): an IndexSource wraps one segment with
a generation; an IndexSourcesCollection is a generation-ordered set of
sources where each source's documents are shadowed by the updated/erased
doc ids of all *newer* sources (scanner_registry_for,
index_source.cpp:3-30): updates and deletions never touch old segments,
they are masked at query time. Collection field statistics and document
frequencies are summed over the raw sources, shadowed copies included
(IndexSourcesCollectionBM25Scorer::reset/new_scorer_weight,
similarity.h:209-249), and every source scores with them; per-source
top-k lists merge by (score desc, app docid asc).

The port's sources build the port's Executor on the collection's device
(``IndexSourcesCollection(device="cuda")``, the default, or ``"cpu"``);
``search_batch`` launches every source's batch before it finishes any;
``launch_batch`` / ``finish_batch`` split it, so a caller can launch the
next batch before finishing this one; their spans (``utils/timings.py``),
``collection.launch`` and ``collection.finish``, hold each source's
``exec.launch`` / ``exec.finish`` under the collection's batch id, and
``collection.merge`` the merge. ``exec_rich`` runs rich-match per
source; ``warmup`` sends a workload through ``warmup_driver``. A source's
executor comes from the collection's ``new_executor``: an Executor here, a
MeshExecutor in ``parallel/mesh.py``'s MeshSourcesCollection.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from trinity_tpu_torch.index.format import FieldStatistics, SegmentData
from trinity_tpu_torch.utils.timings import get_tracer, trace


def now_generation() -> int:
    """Generations are microsecond timestamps, like segment dir names
    (segment_index_source.cpp:16-22)."""
    return time.time_ns() // 1000


def merge_results(per_part, n: int, k: int):
    """Per-query merge of per-source (or per-shard) results: (score desc,
    app docid asc), top k."""
    out = []
    for qi in range(n):
        merged = [r for res in per_part for r in res[qi]]
        merged.sort(key=lambda r: (-r.score, r.doc_id))
        out.append(merged[:k])
    return out


@dataclass
class IndexSource:
    """One searchable segment + generation (index_source.h:18-155), with
    the device its executor runs on, or `make` (segment -> executor) to
    build that executor otherwise."""

    seg: SegmentData
    generation: int
    device: str = "cuda"
    make: Optional[Callable] = None
    _executor: object = None

    def executor(self):
        if self._executor is None:
            if self.make is not None:
                self._executor = self.make(self.seg)
            else:
                from trinity_tpu_torch.exec.executor import Executor

                self._executor = Executor(self.seg, device=self.device)
        return self._executor

    @property
    def updated_ids(self) -> np.ndarray:
        return self.seg.updated_ids

    def index_empty(self) -> bool:
        return self.seg.n_docs == 0


class IndexSourcesCollection:
    """Generation-ordered sources + per-source masked registries
    (index_source.h:191-238), searched on `device`."""

    def __init__(self, device: str = "cuda"):
        self.device = device
        self.sources: List[IndexSource] = []
        self._committed = False

    def insert(self, source: IndexSource) -> None:
        self.sources.append(source)
        self._committed = False

    def new_executor(self, seg: SegmentData):
        """The executor a source added by add_segment searches with."""
        from trinity_tpu_torch.exec.executor import Executor

        return Executor(seg, device=self.device)

    def add_segment(self, seg: SegmentData, generation: Optional[int] = None):
        self.insert(IndexSource(seg, generation or now_generation(),
                                self.device, self.new_executor))
        return self

    def commit(self) -> "IndexSourcesCollection":
        """Sort newest-first and install masked registries: source i is
        masked by the union of updated ids of all newer sources
        (index_source.cpp:3-30)."""
        self.sources.sort(key=lambda s: -s.generation)
        newer_updates: List[np.ndarray] = []
        acc = np.zeros(0, np.uint32)
        for src in self.sources:  # newest -> oldest
            newer_updates.append(acc)
            if len(src.updated_ids):
                acc = np.union1d(acc, src.updated_ids)
        for src, masked_app in zip(self.sources, newer_updates):
            ex = src.executor()
            if len(masked_app) == 0:
                ex.set_masked_local_docs(None)
                continue
            # local ids whose app id is shadowed (sorted-array intersection,
            # the masked_documents_registry::test analog)
            idx = np.searchsorted(masked_app, src.seg.doc_map)
            idx = np.minimum(idx, len(masked_app) - 1)
            hit = masked_app[idx] == src.seg.doc_map
            ex.set_masked_local_docs(np.flatnonzero(hit))
        self._committed = True
        return self

    # -------------------------------------------------- aggregated scoring
    def aggregated_stats(self) -> FieldStatistics:
        """similarity.h:146-158 reset() aggregation."""
        st = FieldStatistics()
        for src in self.sources:
            s = src.seg.stats
            st.sum_term_hits += s.sum_term_hits
            st.total_terms += s.total_terms
            st.sum_terms_docs += s.sum_terms_docs
            st.docs_cnt += s.docs_cnt
        return st

    def doc_freq(self, term: str) -> int:
        """Aggregate df across sources (similarity.h:209-217)."""
        df = 0
        for src in self.sources:
            tid = src.seg.term_id(term)
            if tid >= 0:
                df += int(src.seg.term_df[tid])
        return df

    # ------------------------------------------------------------- search
    def search(self, query, k: int = 10, scorer: str = "bm25"):
        """exec_query over every source + deterministic top-k merge
        (exec.h:63-81; merging contract exec.h:55-58)."""
        return self.search_batch([query], k=k, scorer=scorer)[0]

    def search_batch(self, queries, k: int = 10, scorer: str = "bm25"):
        """Every non-empty source's batch is launched before any is
        finished (the async analog of the per-source std::async fan-out,
        exec.h:132-154), then per-query results merge."""
        return self.finish_batch(self.launch_batch(queries, k, scorer))

    def launch_batch(self, queries, k: int = 10, scorer: str = "bm25"):
        """Launch every non-empty source's batch with the collection's
        statistics, waiting for none; returns a handle for finish_batch
        (so a caller can launch the next batch before finishing this)."""
        if not self._committed:
            self.commit()
        batch = get_tracer().new_batch()
        with trace("collection.launch", batch=batch):
            stats = self.aggregated_stats()
            handles = []
            for src in self.sources:
                if src.index_empty():
                    continue
                ex = src.executor()
                handles.append((ex, ex.launch_batch(
                    queries, k=k, scorer=scorer, stats=stats,
                    df_of=self.doc_freq)))
        return handles, len(queries), k, batch

    def finish_batch(self, handle):
        """Finish each source's batch of a launch_batch handle and merge
        the per-query results."""
        handles, n, k, batch = handle
        with trace("collection.finish", batch=batch):
            per_source = [ex.finish_batch(h) for ex, h in handles]
            with trace("collection.merge", sources=len(per_source)):
                return merge_results(per_source, n, k)

    def search_pruned(self, query, k: int = 10, scorer: str = "bm25",
                      chunk_windows: int = 16):
        return self.search_pruned_batch([query], k, scorer, chunk_windows)[0]

    def search_pruned_batch(self, queries, k: int = 10,
                            scorer: str = "bm25", chunk_windows: int = 16):
        """Block-max pruned search across generations: per-source pruned
        loops with the collection's statistics (results equal
        search_batch's), then the same merge."""
        if not self._committed:
            self.commit()
        stats = self.aggregated_stats()
        per_source = [
            src.executor().search_pruned_batch(
                queries, k, scorer, chunk_windows, stats, self.doc_freq
            )
            for src in self.sources
            if not src.index_empty()
        ]
        return merge_results(per_source, len(queries), k)

    def match_ids(self, query) -> np.ndarray:
        """Matching app ids over every source under its masked registry,
        ascending and unique."""
        if not self._committed:
            self.commit()
        out = [src.executor().match_ids(query) for src in self.sources]
        return np.unique(np.concatenate(out)) if out else np.zeros(0, np.uint32)

    def exec_rich(self, query, on_match, **kwargs) -> int:
        """Default rich-match mode across generations: per-source
        exec_rich under the installed masked registries (newest source
        first). Callback order is ascending per source; cross-source
        merging is the caller's concern, exactly the reference's
        multi-source contract (exec.h:55-62). Returns total matches."""
        if not self._committed:
            self.commit()
        total = 0
        for src in self.sources:
            if not src.index_empty():
                total += src.executor().exec_rich(query, on_match, **kwargs)
        return total

    def warmup(self, queries, k: int = 10, scorer: str = "bm25",
               batch: bool = True, threads: int = 8) -> dict:
        """Every query, and with `batch` the whole list, through the
        collection on `threads` threads (exec/executor.py:warmup_driver):
        each source's executor builds its caches and runs its launch
        shapes. Returns {"programs", "variants", "seconds"}."""
        from trinity_tpu_torch.exec.executor import warmup_driver

        if not self._committed:
            self.commit()  # once, before the threads search
        return warmup_driver(self, queries, k, scorer, batch, threads)

    # ------------------------------------------------------------ persist
    def persist(self, root: str) -> None:
        """One directory per generation (segment_index_source.cpp:16-22)."""
        for src in self.sources:
            src.seg.persist(os.path.join(root, str(src.generation)))

    @classmethod
    def load(cls, root: str, device: str = "cuda") -> "IndexSourcesCollection":
        c = cls(device)
        for name in sorted(os.listdir(root)):
            path = os.path.join(root, name)
            if os.path.isdir(path) and os.path.exists(os.path.join(path, "id")):
                c.add_segment(SegmentData.load(path), int(name))
        return c.commit()
