# Copy of _StatsProxy and split_segment of trinity_tpu/parallel/mesh.py (:35-91).
"""Mesh-sharded serving: a segment range-partitioned into shards, each
searched by its own Executor on one of a list of torch devices.

Counterpart of ``trinity_tpu/parallel/mesh.py`` (the reference's
exec_query_par: thread-per-source fan-out with a caller-side merge,
exec.h:86-177). The reference is single-controller: one process builds
the mesh, runs the shards, fetches their top-k rows and merges them on the
host. So is the port: one process drives a list of devices
(``MeshExecutor(seg, devices=..., n_shards=...)``; by default every
visible CUDA card, shard s on ``devices[s % len(devices)]``, so four
shards may share one card), and no process group is needed.

What it keeps of the reference's contracts:

  - ``split_segment`` (a copy): window-aligned docid ranges, one decode of
    the whole segment, each shard rebuilt by the builder;
  - collection statistics over the shards: ``doc_freq`` and ``docs_cnt``
    are sums, so a sharded index scores exactly as the unsharded one;
  - ``set_masked_local_docs`` takes global (mesh-local) docids and gives
    each shard its slice;
  - ``launch_batch`` / ``finish_batch`` / ``search_batch`` (and ``launch``
    / ``finish`` / ``search``): each query is planned once, every shard's
    batch is launched before any is finished, and each query's shard rows
    merge by (score desc, global docid asc) before the doc map;
  - ``search_pruned(_batch)``, ``match_ids`` (a union) and ``exec_rich``
    (drained in shard order, ``AbortSearch`` stopping the shards still
    running, ``filter_factory`` called once per shard) on a thread pool
    over the shards; ``warmup`` through ``warmup_driver``.

A shard's unresolved lazy phrase and phrase host routes are its own
Executor's. What the reference needed for shard_map and the tunnel does
not carry over: uniform padded shard geometry, stacked hit streams,
docids packed into f32 rows, the AOT cache's mesh key.

``MeshSourcesCollection`` is the IndexSourcesCollection whose sources are
MeshExecutors (BASELINE config #5): newest-first masks on each source's
shards, every source's shards launched before any is finished, one merge.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from trinity_tpu_torch.exec.executor import (
    Executor,
    SearchResult,
    _resolve_device,
    plan_queries,
    warmup_driver,
)
from trinity_tpu_torch.exec.richmatch import AbortSearch
from trinity_tpu_torch.index.format import SegmentData
from trinity_tpu_torch.index.source import IndexSourcesCollection, merge_results
from trinity_tpu_torch.limits import MAX_SEGMENT_DOCS, WINDOW_SIZE
from trinity_tpu_torch.utils.metrics import get_metrics

MAX_THREADS = 8  # the reference's pool bound for the per-shard fan-out


class _StatsProxy:
    """Aggregated stats carrier for per-shard scoring (docs_cnt only)."""

    def __init__(self, docs_cnt: int):
        self.docs_cnt = docs_cnt


def split_segment(seg: SegmentData, n_shards: int) -> List[SegmentData]:
    """Range-partition a segment's local docid space into n_shards
    sub-segments (window-aligned). This is the offline shard builder; in
    production the indexer emits shards directly (segments are already the
    unit of distribution, SURVEY §5.8).

    Fully vectorized: ONE whole-segment decode (decode_all_postings — the
    native linear pass when built) expands to the hit stream, each shard is
    a range mask over it, and because the builder lexsorted hits by
    (term, doc, pos) every masked subset is already in build order — no
    per-term/per-block Python and no re-sort (r2 judge weak-item #5;
    sharding the 1M-doc bench segment now takes seconds, not minutes)."""
    from trinity_tpu_torch.index.builder import _build_segment
    from trinity_tpu_torch.index.format import decode_all_postings

    tids, docs, freqs = decode_all_postings(seg)
    counts = freqs.astype(np.int64)
    total_hits = int(counts.sum())
    # int32 streams: docids < 2^24 (limits.MAX_SEGMENT_DOCS) and term ids
    # fit comfortably — the transient hit stream is the peak-RSS driver
    # when sharding a large segment on this host
    hit_doc = np.repeat(docs.astype(np.int32), counts)
    hit_tid = np.repeat(tids.astype(np.int32), counts)
    pos = np.asarray(seg.positions[:total_hits])
    pay = (
        seg.payloads[:total_hits] if seg.payloads is not None else None
    )
    terms = list(seg.terms_list())
    W = seg.n_windows
    w_per = -(-W // n_shards)
    shards = []
    for s in range(n_shards):
        lo = s * w_per * WINDOW_SIZE
        hi = min((s + 1) * w_per * WINDOW_SIZE, seg.n_docs)
        if lo >= seg.n_docs:
            lo = hi = seg.n_docs
        sel = (hit_doc >= lo) & (hit_doc < hi)
        shards.append(
            _build_segment(
                seg.doc_map[lo:hi].astype(np.uint32),
                terms,
                hit_tid[sel],
                hit_doc[sel] - lo,
                pos[sel],
                pay[sel] if pay is not None else None,
                seg.updated_ids,
                hi - lo,
            )
        )
    return shards


def mesh_devices(devices=None) -> List[torch.device]:
    """The devices shards go to: every visible CUDA card by default
    (raises without one), else a device or a list of them."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "devices=None: torch.cuda.is_available() is False")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    return [_resolve_device(d) for d in devices]


def _merge(rows, k: int):
    """Per-query merge of shard rows [(scores, global docids)]: the top k
    by (score desc, docid asc)."""
    v = np.concatenate([r[0] for r in rows])
    i = np.concatenate([r[1] for r in rows])
    order = np.lexsort((i, -v))[:k]
    return v[order], i[order]


class MeshExecutor:
    """Sharded search session over a list of devices (the exec_query_par
    analog). Pass segments pre-sharded by docid range (split_segment) or a
    single segment, split into `n_shards` (default: one per device)."""

    def __init__(self, seg_or_shards, devices=None,
                 n_shards: Optional[int] = None):
        devs = mesh_devices(devices)
        if isinstance(seg_or_shards, SegmentData):
            self.shards = split_segment(seg_or_shards, n_shards or len(devs))
        else:
            self.shards = list(seg_or_shards)
        total_docs = sum(s.n_docs for s in self.shards)
        if total_docs >= MAX_SEGMENT_DOCS:
            # the reference packs GLOBAL docids (shard base + local) into
            # f32 rows: its envelope spans the summed docid space, and the
            # port keeps it so a mesh serves in both packages alike
            raise ValueError(
                f"mesh collection spans {total_docs} docs >= 2^24 "
                "(f32-exact docid envelope, limits.MAX_SEGMENT_DOCS): "
                "split into multiple MeshExecutors/sources"
            )
        self.devices = [devs[s % len(devs)] for s in range(len(self.shards))]
        bases = np.zeros(len(self.shards), np.int64)
        np.cumsum([s.n_docs for s in self.shards[:-1]], out=bases[1:])
        self._base_np = bases
        # global docid -> app id translation table
        self.doc_map = (np.concatenate([s.doc_map for s in self.shards])
                        if self.shards else np.zeros(0, np.uint32))
        self.executors = [Executor(s, device=d)
                          for s, d in zip(self.shards, self.devices)]

    def _live(self):
        """(shard index, executor) of every shard holding documents."""
        return [(s, ex) for s, ex in enumerate(self.executors)
                if self.shards[s].n_docs]

    def _fan_out(self, fn):
        """fn(executor) for every live shard on a thread pool (device work
        releases the GIL, so shards overlap); results in shard order."""
        live = [ex for _, ex in self._live()]
        if not live:
            return []
        with cf.ThreadPoolExecutor(max_workers=min(MAX_THREADS,
                                                   len(live))) as pool:
            return list(pool.map(fn, live))

    # ------------------------------------------------------------ plumbing
    def set_masked_local_docs(self, global_ids: Optional[np.ndarray]):
        """Install a deletion/update mask (masked_documents_registry
        analog): global_ids are mesh-local docids (0..sum of shard sizes);
        each shard's executor receives its slice."""
        gids = np.asarray([] if global_ids is None else global_ids, np.int64)
        shard_of = np.searchsorted(self._base_np, gids, side="right") - 1
        for s, ex in enumerate(self.executors):
            local = gids[shard_of == s] - self._base_np[s]
            ex.set_masked_local_docs(local if len(local) else None)

    # ---------------------------------------------------------------- stats
    def doc_freq(self, term: str) -> int:
        df = 0
        for s in self.shards:
            tid = s.term_id(term)
            if tid >= 0:
                df += int(s.term_df[tid])
        return df

    @property
    def docs_cnt(self) -> int:
        return sum(s.n_docs for s in self.shards)

    def _stats(self, stats, df_of):
        """Collection statistics for every shard's weights: the caller's,
        else the mesh's sums (so shards score as the unsharded segment)."""
        return (stats or _StatsProxy(self.docs_cnt),
                df_of if df_of is not None else self.doc_freq)

    # --------------------------------------------------------------- search
    def launch_batch(self, queries: Sequence, k: int = 10,
                     scorer: str = "bm25", stats=None, df_of=None):
        """Plan each query once and launch every live shard's batch with
        the mesh's statistics, waiting for none; returns a handle for
        finish_batch."""
        t0 = time.perf_counter()
        get_metrics().count("search.queries", len(queries))
        stats, df_of = self._stats(stats, df_of)
        plans = plan_queries(queries)
        handles = [(s, ex, ex.launch_groups(plans, k, scorer, stats, df_of))
                   for s, ex in self._live()]
        return handles, len(plans), k, t0

    def finish_batch(self, handle) -> List[List[SearchResult]]:
        """Finish every shard's batch, then merge each query's shard rows
        by (score desc, global docid asc) and map through doc_map."""
        handles, n, k, t0 = handle
        rows = [(self._base_np[s], ex.finish_rows(h)) for s, ex, h in handles]
        out = []
        for qi in range(n):
            if not rows:
                out.append([])
                continue
            v, i = _merge([(r[qi][0], r[qi][1] + base) for base, r in rows],
                          k)
            out.append([SearchResult(int(self.doc_map[g]), float(x))
                        for x, g in zip(v, i)])
        get_metrics().observe_us("search.batch_latency",
                                 (time.perf_counter() - t0) * 1e6)
        return out

    def search_batch(self, queries: Sequence, k: int = 10,
                     scorer: str = "bm25", stats=None, df_of=None):
        return self.finish_batch(
            self.launch_batch(queries, k, scorer, stats, df_of))

    def launch(self, query, k: int = 10, scorer: str = "bm25", stats=None,
               df_of=None):
        """Launch one query without waiting (a batch of one); returns a
        pending handle for finish(), None when the query parses to
        nothing."""
        plans = plan_queries([query])
        if plans[0] is None:
            return None
        return self.launch_batch(plans, k, scorer, stats, df_of)

    def finish(self, pending, k: int = 10) -> List[SearchResult]:
        """Results of a launch() handle."""
        return [] if pending is None else self.finish_batch(pending)[0]

    def search(self, query, k: int = 10, scorer: str = "bm25", stats=None,
               df_of=None) -> List[SearchResult]:
        return self.search_batch([query], k, scorer, stats, df_of)[0]

    # -------------------------------------------------------- pruned search
    def search_pruned(self, query, k: int = 10, scorer: str = "bm25",
                      chunk_windows: int = 16, stats=None, df_of=None):
        return self.search_pruned_batch(
            [query], k, scorer, chunk_windows, stats, df_of
        )[0]

    def search_pruned_batch(self, queries, k: int = 10, scorer: str = "bm25",
                            chunk_windows: int = 16, stats=None, df_of=None):
        """Block-max pruned top-k over the mesh: each shard's pruning loop
        (exec/pruned.py) on a thread pool, with the mesh's statistics, so
        the results equal search_batch's; one merge per query."""
        stats, df_of = self._stats(stats, df_of)
        plans = plan_queries(queries)
        per_shard = self._fan_out(lambda ex: ex.search_pruned_batch(
            plans, k, scorer, chunk_windows, stats, df_of))
        # shards are ascending app-id ranges: (score, app docid) order is
        # (score, global docid) order
        return merge_results(per_shard, len(plans), k)

    # ------------------------------------------------------- other exec modes
    def match_ids(self, query) -> np.ndarray:
        """DocumentsOnly mode over the mesh: each shard's match_ids on the
        thread pool, their union (ascending app doc ids)."""
        parts = [p for p in self._fan_out(lambda ex: ex.match_ids(query))
                 if len(p)]
        return (np.unique(np.concatenate(parts)) if parts
                else np.zeros(0, np.uint32))

    def exec_rich(self, query, on_match, filter_factory=None,
                  **kwargs) -> int:
        """Default (rich-match) mode over the mesh: every shard's exec_rich
        on the thread pool, buffering its MatchedDocuments, drained in
        shard order on the caller's thread, so on_match sees ascending doc
        ids as on one executor while later shards still run.

        AbortSearch from on_match stops delivery and makes the shards still
        running stop at their next match. filter_factory, if given, is
        called once per shard and returns that shard's exec_rich kwargs
        (e.g. on_prepare / doc_filter: one filter instance per source,
        exec.h:55-62); kwargs given directly are shared by the shards and
        must be thread-safe. Returns the matches delivered."""
        aborted = threading.Event()

        def run_shard(src):
            buf = []

            def collect(md):
                if aborted.is_set():
                    raise AbortSearch()
                buf.append(md)

            per_src = dict(kwargs)
            if filter_factory is not None:
                per_src.update(filter_factory())
            src.exec_rich(query, collect, **per_src)
            return buf

        delivered = 0
        if not self.executors:
            return 0
        with cf.ThreadPoolExecutor(max_workers=min(
                MAX_THREADS, len(self.executors))) as pool:
            futs = [pool.submit(run_shard, src) for src in self.executors]
            for f in futs:
                buf = f.result()  # a shard's own error is raised here
                if aborted.is_set():
                    continue
                for md in buf:
                    try:
                        on_match(md)
                    except AbortSearch:
                        aborted.set()
                        break
                    delivered += 1
        return delivered

    def warmup(self, queries, k: int = 10, scorer: str = "bm25",
               batch: bool = True, threads: int = 8) -> dict:
        """Every query, and with `batch` the whole list, through the mesh
        on `threads` threads (warmup_driver): each shard's executor builds
        its caches and runs its launch shapes."""
        return warmup_driver(self, queries, k, scorer, batch, threads)


class MeshSourcesCollection(IndexSourcesCollection):
    """Generation-ordered index sources, each sharded over the devices
    (BASELINE config #5: multi-segment with merge + deletion masks,
    sharded): an IndexSourcesCollection whose sources search with a
    MeshExecutor. Source i's documents are shadowed by the updated/erased
    app ids of all newer sources, installed on each source's shards; a
    search launches every source's shards before it finishes any
    (exec.h:86-177)."""

    def __init__(self, devices=None, n_shards: Optional[int] = None):
        super().__init__(mesh_devices(devices))  # raises without a card
        self.n_shards = n_shards

    def new_executor(self, seg: SegmentData) -> MeshExecutor:
        return MeshExecutor(seg, self.device, self.n_shards)
