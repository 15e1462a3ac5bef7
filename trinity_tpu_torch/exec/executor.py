"""Query executor on one segment: boolean and phrase BM25/TF-IDF/Trivial top-k.

Counterpart of ``trinity_tpu/exec/executor.py`` for ``search`` /
``search_batch`` / ``launch_batch`` / ``finish_batch`` / ``search_many`` /
``launch`` / ``finish`` (AccumulatedScoreScheme), ``match_ids``
(DocumentsOnly) and, through ``exec/pruned.py``, ``search_pruned`` /
``search_pruned_batch``. Every entry point takes the reference's
collection statistics (``stats``, ``df_of``: the weights of a collection
of segments) and ``search`` / ``match_ids`` an app-id ``doc_set``. The
segment arrays are uploaded on first use through the residency manager
(``exec/residency.py``) and may be evicted under its budget. Host planning is
the reference's, in the port's own copies (``exec/planning.py``:
``_plan_for_text``, ``_flatten_tape``, ``_pad_T``, ``_pick_bucket``, the
phrase C/C2 buckets; ``config.batch_buckets``); the device side is torch
plus the four CUDA kernels. Groups of one plan shape share a launch:

  - "flat" (AND/OR/NOT/k-of-n/optional, at most 8 slots): the flat fused
    score kernel, structure as data (ops/fusedscore.py);
  - "fused" (other boolean trees with at most 8 used slots): the tape
    fused score kernel;
  - "dense" (more than 8 slots): the decode kernel, the tape evaluated in
    torch over the decoded tiles, a flat top-k;
  - "posph" (pure phrases where positions are distinct per (term, doc)
    and below 32 * posmask_max_words): the posmask kernel scatters each
    distinct member's position words (or reads them from the posmask hot
    cache), phrase freq = popcount(AND of shifted words) for every doc
    (ops/posmask.py);
  - "lazyph" (other pure phrases): the decode kernel with hit offsets, the
    exact top-C2 candidates by min member freq (ops/select.py), position
    verification on the device (exec/phrases.py), a top-k and a
    `resolved` flag; an unresolved query reruns alone as a compound group;
  - "phrase" (phrases inside boolean trees): the decode kernel with hit
    offsets, the first C candidates per window of each phrase (pass A),
    verification, the tape with the verified phrase tiles (pass C);
  - "lazyhost" and "phrase" without a device cap (no positions stream, or
    a member freq above the FCAP ladder): the same passes with the numpy
    verifier between them.

Each group launches on the current stream. The boolean and posmask groups
never wait for the device, so ``launch_batch`` can overlap the previous
batch; groups that verify positions synchronise to compact the live
candidates (and the host routes to copy them). ``finish_batch`` copies the
ids and scores back. Results rank by score desc, local docid asc.

``match_ids`` plans its query as a batch of one and reads the match from
the group's score tiles (-inf outside it): K2 / K3 for the boolean kinds,
K1 and the tape in torch for the dense kind, the posmask path for pure
phrases (the compound path when posmask is off), the compound path for
phrases inside trees. Counters (``utils/metrics.py``) carry the
reference's names: ``search.queries``, ``search.batch_latency``,
``phrase.host_verify``, ``phrase.dense_fallback``. Spans
(``utils/timings.py``): ``exec.search`` (a search() call), ``exec.launch``
(``launch_groups``, which gives the batch its id and puts it in the
handle) around ``exec.prepare`` (``plan_batch``) and one
``exec.group.<kind>`` per group, ``exec.finish`` (``finish_batch`` /
``finish_rows``) around ``exec.device`` (the wait and the copies back);
``exec.phrase`` around the phrase work on the host (the posmask member
loop, position verification, the host verifier, the lazy reruns). The
counter ``plan.df_lookups`` adds each plan's ``df_of`` calls.
Phrase groups are not padded to a batch bucket: eager torch compiles
nothing per shape.

``warmup`` sends a workload through ``warmup_driver`` on a thread pool;
each group's launch shape and each hot-cache build is recorded for the
seal (``utils/seal.py``). The hot-term caches are built once per executor
under a lock, whichever threads reach them first.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from trinity_tpu_torch.config import get_config
from trinity_tpu_torch.exec.planning import (
    ExecFlags,
    SearchResult,
    _flatten_tape,
    _pad_T,
    _phrase_c_bound,
    _phrase_c_bucket,
    _phrase_group_c2,
    _pick_bucket,
    _pick_c2,
    _plan_for_text,
)
from trinity_tpu_torch.exec import richmatch
from trinity_tpu_torch.exec.pruned import search_pruned_batch
from trinity_tpu_torch.exec.phrases import (
    collect_phrases,
    fcap_bucket,
    verify_phrase_candidates,
    verify_phrases_device,
)
from trinity_tpu_torch.exec.residency import get_residency
from trinity_tpu_torch.index.format import SegmentData
from trinity_tpu_torch.limits import MAX_SEGMENT_DOCS, TILE, WINDOW_SIZE
from trinity_tpu_torch.models.similarity import SIMILARITIES, score_tile
from trinity_tpu_torch.ops.fusedscore import (
    NEG_INF,
    NSUB,
    SUB_DOCS,
    eval_tape_tiles,
    exact_window_topk,
    fused_flat_score_tiles,
    fused_score_tiles,
    tape_used_slots,
    topk_lowest_index,
)
from trinity_tpu_torch.ops.posmask import (
    POS_GUARD_ROWS,
    materialize_posmask_tiles,
    phrase_freq_from_masks,
)
from trinity_tpu_torch.ops.postings import (
    compute_cells,
    materialize_freq_tiles,
    pack_block_meta,
    pad_planes,
)
from trinity_tpu_torch.ops.select import (
    bound_select_candidates,
    compact_mask,
    gather_cols,
)
from trinity_tpu_torch.plan.compile import CompiledPlan, compile_plan
from trinity_tpu_torch.query.parser import Query
from trinity_tpu_torch.utils import seal
from trinity_tpu_torch.utils.metrics import get_metrics
from trinity_tpu_torch.utils.timings import get_tracer, trace

# tapes reading more slots run the dense path (decode + torch tape eval)
FUSED_MAX_SLOTS = 8
HOT_CHUNK = 8  # terms per kernel launch when building the hot-term caches
HOST_VERIFY_CHUNK = 2048  # candidates per step of the lazy host route
_SERIALS = itertools.count()  # names an executor's caches for the seal

# kinds whose launch depends on the tape itself (the rest take it as data)
TAPE_KINDS = ("fused", "dense", "phrase")

__all__ = ["ExecFlags", "Executor", "SearchResult", "plan_queries",
           "state_from_numpy", "warmup_driver"]


def warmup_driver(target, queries, k, scorer, batch, threads) -> dict:
    """Warmup shared by the executor and the collection (the reference's
    ``warmup_driver``): every query through ``target.search``, then, with
    `batch`, the whole list through ``target.search_batch``, on a pool of
    `threads` threads. Every query goes through, not one per tape: the
    launch shapes depend on more than the tape (C2 / fcap buckets, batch
    rows). Returns {"programs": variants first recorded during the call
    (utils/seal.py), "variants": calls submitted, "seconds"}."""
    import concurrent.futures as cf

    t0 = time.perf_counter()
    before = seal.variants_recorded()
    qs = list(queries)
    with cf.ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
        futs = [pool.submit(target.search, q, k=k, scorer=scorer) for q in qs]
        if batch and qs:
            futs.append(pool.submit(target.search_batch, qs, k=k,
                                    scorer=scorer))
        for f in futs:
            f.result()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"programs": seal.variants_recorded() - before,
            "variants": len(qs) + (1 if batch and qs else 0),
            "seconds": time.perf_counter() - t0}


def plan_queries(queries: Sequence) -> list:
    """Each query's CompiledPlan (None when it parses to nothing): a text
    through the parse cache, a Query or AST root compiled, a CompiledPlan
    as it is (a caller that plans once for many executors)."""
    plans = []
    for q in queries:
        if isinstance(q, CompiledPlan):
            plan = q
        elif isinstance(q, str):
            _, plan = _plan_for_text(q)
        else:
            root = q.root if isinstance(q, Query) else q
            plan = compile_plan(root) if root is not None else None
        plans.append(plan)
    return plans


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r}: torch.cuda.is_available() is False"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def state_from_numpy(arrays: dict, device) -> dict:
    """Map the reference executor's device arrays, given as numpy, to the
    port's tensors on `device`.

    Keys: "bmeta" (pack_block_meta, i32), "planes" (pad_planes, u32 — kept
    as its i32 bit-view), "hit_pw" (position planes, u32, as i32),
    "hit_off" (position group offsets, i32), "tf_planes" (hot-term planes,
    f32) and "deleted_tiles" ((W, 128, 128) f32, 1.0 = masked). None stays
    None."""
    dtypes = {"bmeta": np.int32, "planes": np.int32, "hit_pw": np.int32,
              "hit_off": np.int32, "tf_planes": np.float32,
              "deleted_tiles": np.float32}
    out = {}
    for name, a in arrays.items():
        if name not in dtypes:
            raise KeyError(f"unknown state array {name!r}")
        if a is None:
            out[name] = None
            continue
        # contiguous and writable (a read-only view, e.g. of a JAX buffer,
        # is copied: torch tensors assume they may write their memory)
        a = np.require(a, requirements=["C", "W"])
        want = dtypes[name]
        if a.dtype.itemsize == 4 and a.dtype.kind in "iu" and want == np.int32:
            a = a.view(np.int32)
        elif a.dtype != want:
            raise TypeError(f"{name}: dtype {a.dtype}, expected {want}")
        out[name] = torch.from_numpy(a).to(device)
    return out


@dataclass
class Group:
    """One device launch of a batch: queries of one plan shape."""

    kind: str  # flat | fused | dense | posph | lazyph | lazyhost | phrase
    tape: Optional[tuple]  # None for flat groups (structure is data)
    members: list  # [(query index, CompiledPlan)]
    T: int  # padded slots per query (posph: phrase members)
    B: int  # batch rows (padded for the boolean kinds)
    arrays: dict  # host inputs uploaded by run_group
    ctx: dict = field(default_factory=dict)  # host-side phrase parameters

    @property
    def variant(self) -> tuple:
        """This launch's shape, as the seal records it (utils/seal.py):
        route (with the tape where the launch depends on it), batch rows,
        slots, cell columns (a posmask group's kernel columns), and the
        phrase routes' C / C2 / fcap buckets."""
        c = self.ctx
        return (self.kind, self.tape if self.kind in TAPE_KINDS else None,
                self.B, self.T, self.arrays["cs"].shape[1], c.get("C"),
                c.get("C2"), c.get("fcaps"))


class Executor:
    """Per-segment search session on one device: ``"cuda"`` (the default;
    raises when torch sees no card) or ``"cpu"`` (the plain versions).

    The segment's block metadata, padded plane matrix and positions stream
    are packed on the host here and uploaded at first use through the
    residency manager, which may evict them under
    ``config.hbm_budget_bytes`` (``evict()`` drops them by hand); an
    evicted executor uploads them again at its next search. Two
    query-independent caches are built at the first batch that reads them,
    by the kernels, in chunks of 8 terms, and stay outside the budget: the
    hot-term frequency planes (highest-df terms within
    ``config.hot_cache_bytes``) and the posmask hot cache (highest-df terms
    with df >= ``posmask_min_df`` within ``posmask_cache_bytes``)."""

    def __init__(self, seg: SegmentData, device="cuda"):
        if seg.n_docs >= MAX_SEGMENT_DOCS:
            # the reference's envelope (its batch programs carry local
            # docids as f32 rows, exact below 2^24); the port keeps it so a
            # segment serves in both packages alike
            raise ValueError(
                f"segment has {seg.n_docs} docs >= 2^24 "
                "(f32-exact docid envelope, limits.MAX_SEGMENT_DOCS): "
                "split it across executors instead"
            )
        self.device = _resolve_device(device)
        self.seg = seg
        hp = np.ascontiguousarray(seg.hit_planes, dtype=np.uint32)
        self._host = {
            "bmeta": pack_block_meta(seg), "planes": pad_planes(seg.planes),
            "hit_pw": np.vstack([hp.reshape(-1, TILE),
                                 np.zeros((POS_GUARD_ROWS, TILE), np.uint32)]),
            "hit_off": seg.hit_group_off.astype(np.int32),
        }
        # what the residency budget counts: the segment arrays
        self.device_bytes = sum(a.nbytes for a in self._host.values())
        self._dev: Optional[dict] = None
        self._upload_lock = threading.Lock()
        self._residency = get_residency()
        # the masked-documents registry (set_masked_local_docs) and the
        # forms the paths read: host bool, device flat bool, f32 tiles
        self._deleted_np = None
        self._deleted = None
        self._deleted_tiles = None
        self._max_freq_cache: dict = {}
        cfg = get_config()
        # the hot-term caches are built at first use, once, under a lock:
        # warmup searches from many threads, and N racing builds would
        # hold N copies of a cache (~1.9 GB on the bench deployment)
        self._cache_lock = threading.Lock()
        self._serial = next(_SERIALS)
        self._tf_planes = None
        self._hot = self._hot_terms(cfg.hot_cache_bytes, cfg.hot_cache_min_df,
                                    seg.n_windows * TILE * TILE * 4)
        # dense positional-bitmask phrase path: the segment's positions
        # must be distinct per (term, doc) (else popcount is not the
        # anchored count) and below 32 * posmask_max_words
        self._pw_words = max(1, -(-(seg.max_position + 1) // 32))
        self._posmask_enabled = bool(
            cfg.use_posmask
            and seg.positions_distinct
            and self._pw_words <= cfg.posmask_max_words
        )
        self._pos_planes = None
        self._pos_hot = (
            self._hot_terms(cfg.posmask_cache_bytes, cfg.posmask_min_df,
                            seg.n_windows * self._pw_words * TILE * TILE * 4)
            if self._posmask_enabled else {}
        )

    def _hot_terms(self, budget: int, min_df: int, per_term: int) -> dict:
        """Highest-df terms with df >= min_df that fit `budget` bytes at
        `per_term` bytes each: {term id: cache row}."""
        if budget <= 0 or self.seg.n_terms == 0:
            return {}
        cap = int(budget // per_term)
        df = np.asarray(self.seg.term_df)
        order = np.argsort(-df, kind="stable")
        order = order[df[order] >= min_df][:cap]
        return {int(t): i for i, t in enumerate(order)}

    @property
    def device_bytes_held(self) -> int:
        """Bytes this executor holds on its device now: the segment arrays
        while resident, the hot-term caches once built, the deletion
        masks."""
        ts = (*(self._dev or {}).values(), self._tf_planes,
              self._pos_planes, self._deleted_tiles, self._deleted)
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    # --------------------------------------------------- device residency
    def _upload(self) -> None:
        self._dev = state_from_numpy(self._host, self.device)

    def evict(self) -> None:
        """Drop the segment arrays from the device; the next search uploads
        them again."""
        self._dev = None

    # read from the dict ensure() returns: another thread's ensure() may
    # evict this executor the moment it returns
    @property
    def bmeta(self) -> torch.Tensor:
        return self._residency.ensure(self)["bmeta"]

    @property
    def planes(self) -> torch.Tensor:
        return self._residency.ensure(self)["planes"]

    @property
    def hit_pw(self) -> torch.Tensor:
        return self._residency.ensure(self)["hit_pw"]

    @property
    def hit_off(self) -> torch.Tensor:
        return self._residency.ensure(self)["hit_off"]

    # ---------------------------------------------------- hot-term caches
    @property
    def tf_planes(self) -> torch.Tensor:
        """(C, W, 128, 128) f32 frequency planes of the hot terms (a
        (1, 1, 128, 128) zero dummy when none qualify — the kernels never
        read it when every cid is -1)."""
        if self._tf_planes is None:
            with self._cache_lock:
                if self._tf_planes is None:
                    seal.record(("tf_planes", self._serial))
                    self._tf_planes = self._build_tf_planes()
        return self._tf_planes

    def _build_tf_planes(self) -> torch.Tensor:
        if not self._hot:
            return torch.zeros((1, 1, TILE, TILE), device=self.device)
        seg = self.seg
        W = seg.n_windows
        order = sorted(self._hot, key=self._hot.get)
        out = torch.empty((len(order), W, TILE, TILE), device=self.device)
        for i in range(0, len(order), HOT_CHUNK):
            tids = order[i : i + HOT_CHUNK]
            cs, cn = compute_cells(seg, tids)
            # the kernel writes the chunk's tiles into the cache in place
            materialize_freq_tiles(
                self.bmeta, self.planes, self._put(cs), self._put(cn),
                out=out[i : i + len(tids)].transpose(0, 1),
            )
        return out

    @property
    def pos_planes(self) -> torch.Tensor:
        """(W, C, PW, 128, 128) i32 position words of the posmask hot
        terms (a (1, 1, 1, 1, 1) zero dummy when none qualify)."""
        if self._pos_planes is None:
            with self._cache_lock:
                if self._pos_planes is None:
                    seal.record(("pos_planes", self._serial))
                    self._pos_planes = self._build_pos_planes()
        return self._pos_planes

    def _build_pos_planes(self) -> torch.Tensor:
        if not self._pos_hot:
            return torch.zeros((1,) * 5, dtype=torch.int32, device=self.device)
        seg = self.seg
        W, PW = seg.n_windows, self._pw_words
        order = sorted(self._pos_hot, key=self._pos_hot.get)
        out = torch.empty((W, len(order), PW, TILE, TILE), dtype=torch.int32,
                          device=self.device)
        for i in range(0, len(order), HOT_CHUNK):
            tids = order[i : i + HOT_CHUNK]
            cs, cn = compute_cells(seg, tids)
            # the kernel writes the chunk's words into the cache in place
            materialize_posmask_tiles(
                self.bmeta, self.planes, self.hit_pw, self.hit_off,
                self._put(cs), self._put(cn), PW,
                out=out[:, i : i + len(tids)],
            )
        return out

    def _cids_for(self, tids, T: int) -> np.ndarray:
        """Per-slot hot-cache plane ids (length T, -1 = decode)."""
        out = np.full(T, -1, np.int32)
        for s, tid in enumerate(tids):
            out[s] = self._hot.get(int(tid), -1)
        return out

    def set_masked_local_docs(self, local_ids: Optional[np.ndarray]):
        """Install the masked-documents registry: local ids whose documents
        are shadowed by newer segments (None or empty clears it)."""
        if local_ids is None or len(local_ids) == 0:
            self._deleted_np = self._deleted = self._deleted_tiles = None
            return
        m = np.zeros(self.seg.n_windows * WINDOW_SIZE, bool)
        m[np.asarray(local_ids)] = True
        self._install_mask(m)

    def _install_mask(self, m: np.ndarray) -> None:
        """The three forms the paths read: host bool, device flat bool,
        device f32 tiles (1.0 = masked)."""
        W = self.seg.n_windows
        self._deleted_np = m
        self._deleted = self._put(m)
        self._deleted_tiles = self._put(
            m.reshape(W, TILE, TILE).astype(np.float32)
        )

    def _doc_set_masks(self, doc_set):
        """Mask, for one call, every document outside the app-id set
        `doc_set` (the VectorIDs node, docset_iterators.cpp:415-452), on
        top of the installed registry. Returns the saved forms."""
        seg = self.seg
        saved = (self._deleted_np, self._deleted, self._deleted_tiles)
        ids = np.asarray(doc_set, np.int64)
        m = np.ones(seg.n_windows * WINDOW_SIZE, bool)
        if seg.n_docs and len(ids):
            # app ids -> local ids through the sorted doc_map
            idx = np.minimum(np.searchsorted(seg.doc_map, ids), seg.n_docs - 1)
            m[idx[seg.doc_map[idx] == ids]] = False
        if self._deleted_np is not None:
            m |= self._deleted_np
        self._install_mask(m)
        return saved

    def _restore_masks(self, saved) -> None:
        self._deleted_np, self._deleted, self._deleted_tiles = saved

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without blocking the host: through
        pinned memory, so a batch's inputs upload while the previous batch
        still runs."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -------------------------------------------------------------- search
    def warmup(self, queries, k: int = 10, scorer: str = "bm25",
               batch: bool = True, threads: int = 8) -> dict:
        """Run every query, and with `batch` the whole list as one batch,
        on `threads` threads (warmup_driver): the kernel library, the
        hot-term caches and every launch shape the workload touches are
        built or recorded before serving, so ``seal_programs`` can then
        hold serving to them. Returns {"programs", "variants",
        "seconds"}."""
        return warmup_driver(self, queries, k, scorer, batch, threads)

    def search(self, query, k: int = 10, scorer: str = "bm25", stats=None,
               df_of=None, doc_set=None) -> List[SearchResult]:
        """Ranked top-k of one query (AccumulatedScoreScheme, exec.h:25-34):
        a batch of one. stats / df_of: collection statistics (docs_cnt,
        term -> df) for the weights, else the segment's own. doc_set: app
        ids the query is ANDed with (docset_iterators.cpp:415-452)."""
        if doc_set is not None:
            saved = self._doc_set_masks(doc_set)
            try:
                return self.search(query, k, scorer, stats, df_of)
            finally:
                self._restore_masks(saved)
        with trace("exec.search"):
            return self.search_batch([query], k, scorer, stats, df_of)[0]

    def search_batch(self, queries: Sequence, k: int = 10,
                     scorer: str = "bm25", stats=None,
                     df_of=None) -> List[List[SearchResult]]:
        """Queries grouped by plan shape, each group one launch."""
        return self.finish_batch(
            self.launch_batch(queries, k, scorer, stats, df_of))

    def search_many(self, queries: Sequence, k: int = 10,
                    scorer: str = "bm25", stats=None,
                    df_of=None) -> List[List[SearchResult]]:
        """Multi-query execution: search_batch, as in the reference."""
        return self.search_batch(queries, k, scorer, stats, df_of)

    def launch(self, query, k: int = 10, scorer: str = "bm25", stats=None,
               df_of=None):
        """Launch one query without waiting (a batch of one); returns a
        pending handle for finish(), None when the query parses to
        nothing."""
        h = self.launch_batch([query], k, scorer, stats, df_of)
        return h if h[0] else None

    def finish(self, pending) -> List[SearchResult]:
        """Results of a launch() handle."""
        return [] if pending is None else self.finish_batch(pending)[0]

    def search_pruned(self, query, k: int = 10, scorer: str = "bm25",
                      chunk_windows: int = 16, stats=None,
                      df_of=None) -> List[SearchResult]:
        """Block-max pruned top-k of one query (exec/pruned.py): a pruned
        batch of one; results equal search()'s."""
        return self.search_pruned_batch([query], k, scorer, chunk_windows,
                                        stats, df_of)[0]

    def search_pruned_batch(self, queries: Sequence, k: int = 10,
                            scorer: str = "bm25", chunk_windows: int = 16,
                            stats=None,
                            df_of=None) -> List[List[SearchResult]]:
        """Block-max pruned top-k of a batch (exec/pruned.py): windows in
        descending-bound chunks of `chunk_windows`, each chunk one decode
        launch, stopping per query once its k-th score beats every bound
        left; results equal search_batch()'s."""
        return search_pruned_batch(self, queries, k, scorer, chunk_windows,
                                   stats, df_of)

    def match_ids(self, query, scorer: str = "trivial",
                  doc_set=None) -> np.ndarray:
        """DocumentsOnly execution (exec.h:12-23): the matching app doc ids,
        ascending. The query runs as a batch of one on its search route
        (a lazy phrase group on the compound path instead) and its match is
        read from the group's scores. doc_set: as in search()."""
        if doc_set is not None:
            saved = self._doc_set_masks(doc_set)
            try:
                return self.match_ids(query, scorer)
            finally:
                self._restore_masks(saved)
        groups = self.plan_batch([query], scorer, k=1)
        if not groups or self.seg.n_docs == 0:
            return np.zeros(0, np.uint32)
        g = groups[0]
        if g.kind in ("lazyph", "lazyhost"):
            g = self._prep_phrase_compound(g.tape, g.members, g.ctx)
        seal.record(("match_ids", *g.variant))
        a = {n: self._put(v) for n, v in g.arrays.items()}
        if g.kind in ("flat", "fused"):
            scores = self._score_tiles(g, a, scorer)[0]
        else:
            scores = {"dense": self._dense_scores,
                      "posph": self._posph_scores,
                      "phrase": self._compound_scores}[g.kind](g, a, scorer)
        local = torch.nonzero(scores.reshape(-1) > NEG_INF).reshape(-1)
        return self.seg.doc_map[local.cpu().numpy()]

    def exec_rich(self, query, on_match, **kwargs) -> int:
        """Default (rich-match) mode on this executor: exec/richmatch.py's
        exec_rich, with its keyword arguments."""
        return richmatch.exec_rich(self, query, on_match, **kwargs)

    def _parse(self, queries: Sequence) -> list:
        """Each query's CompiledPlan (None when it parses to nothing)."""
        return plan_queries(queries)

    def _weighting(self, stats, df_of):
        """(docs_cnt, term -> df) for the weights: the collection's when
        given, else the segment's own (the reference's ``_prepare``)."""
        seg = self.seg
        if df_of is None:
            df_of = lambda t: (
                int(seg.term_df[seg.term_id(t)]) if seg.term_id(t) >= 0 else 0
            )
        return (stats.docs_cnt if stats else seg.stats.docs_cnt), df_of

    def _bool_arrays(self, members, T: int, B: int, flat: bool, model,
                     docs_cnt: int, df_of):
        """A boolean group's host inputs, T columns a query and B rows:
        {"cs", "cn": (W, B*T) cell tables, "weights": (B, T) per slot for a
        flat group, else (B, weight nodes); a flat group's "flags" (B, T)
        and "kmin" (B,), pad rows kmin = T + 1 (they match nothing)}; the
        (B*T,) hot-cache plane ids (-1 = decode); each member's f32 weight
        per weight node."""
        seg = self.seg
        cs = np.zeros((seg.n_windows, B * T), np.int32)
        cn = np.zeros_like(cs)
        cids = np.full(B * T, -1, np.int32)
        nw = T if flat else len(members[0][1].weight_terms)
        arrays = {"cs": cs, "cn": cn,
                  "weights": np.zeros((B, nw), np.float32)}
        if flat:
            arrays.update(flags=np.zeros((B, T), np.int32),
                          kmin=np.full(B, T + 1, np.int32))
        wrows = []
        for bi, (_, plan) in enumerate(members):
            tids = [seg.term_id(t) for t in plan.term_texts]
            cols = slice(bi * T, bi * T + plan.n_slots)
            cs[:, cols], cn[:, cols] = compute_cells(seg, tids)
            cids[cols] = self._cids_for(tids, plan.n_slots)
            wrow = np.array([model.weight([df_of(t) for t in terms], docs_cnt)
                             for terms in plan.weight_terms], np.float32)
            wrows.append(wrow)
            if flat:
                fl, wsel, km = _flatten_tape(plan.tape, plan.n_slots)
                arrays["flags"][bi, : plan.n_slots] = fl
                arrays["kmin"][bi] = km
                for s, wi in enumerate(wsel):
                    if wi >= 0:
                        arrays["weights"][bi, s] = wrow[wi]
            else:
                arrays["weights"][bi] = wrow
        return arrays, cids, wrows

    def plan_batch(self, queries: Sequence, scorer: str = "bm25",
                   k: int = 10, stats=None, df_of=None) -> List[Group]:
        """Host planning of a batch (the reference's ``launch_batch``
        grouping and routing): parse, group by shape, route each phrase
        group, and build each group's cell tables and weights, from
        `stats` / `df_of` when given (the reference's ``_prepare``)."""
        model = SIMILARITIES[scorer]
        docs_cnt, weigh_df = self._weighting(stats, df_of)
        lookups = 0

        def df_of(term):
            nonlocal lookups
            lookups += 1
            return weigh_df(term)

        keyed: dict = {}
        phrase_keyed: dict = {}
        for qi, plan in enumerate(self._parse(queries)):
            if plan is None:
                continue
            key = plan.tape
            if plan.has_phrase:
                if key[0] == "phrase":
                    # every same-shape phrase shares a posmask group; lazy
                    # groups split by the query's own C2 bucket
                    key = (key, "pos" if self._posmask_enabled
                           else _phrase_group_c2(df_of, plan, key[1], k))
                phrase_keyed.setdefault(key, []).append((qi, plan))
                continue
            T = _pad_T(plan.n_slots)
            if (T <= FUSED_MAX_SLOTS
                    and _flatten_tape(key, plan.n_slots) is not None):
                key = ("flat", T)
            keyed.setdefault(key, []).append((qi, plan))

        buckets = get_config().batch_buckets
        groups = []
        for key, members in keyed.items():
            flat = key[0] == "flat"
            T = key[1] if flat else _pad_T(members[0][1].n_slots)
            B = _pick_bucket(buckets, len(members))
            arrays, cids, _ = self._bool_arrays(members, T, B, flat, model,
                                                docs_cnt, df_of)
            if flat:
                kind, tape = "flat", None
            else:
                used = tape_used_slots(key)
                kind = ("fused" if 1 <= len(used) <= FUSED_MAX_SLOTS
                        else "dense")
                tape = key
            if kind != "dense":
                # cached slots take their tile from the planes, not a decode
                arrays["cn"] = arrays["cn"] * (cids[None, :] < 0)
                arrays["cids"] = cids
            groups.append(Group(kind, tape, members, T, B, arrays))

        ctx = dict(model=model, docs_cnt=docs_cnt, df_of=df_of)
        for key, members in phrase_keyed.items():
            if isinstance(key[0], str):  # compound: phrases inside a tree
                groups.append(self._prep_phrase_compound(key, members, ctx))
                continue
            key = key[0]  # a pure phrase: (tape, "pos" | C2 bucket)
            g = None
            if self._posmask_enabled:
                g = self._prep_phrase_pos(key, members, k, ctx)
            if g is None:
                g = self._prep_phrase_lazy(key, members, k, ctx)
            groups.append(g)
        get_tracer().add("plan.df_lookups", lookups)
        return groups

    def run_group(self, g: Group, k: int, scorer: str):
        """Launch one group; returns device (values (B, k) f32, local docids
        (B, k) int64, resolved (B,) bool for lazyph groups, else None)."""
        with trace(f"exec.group.{g.kind}", B=g.B, T=g.T):
            return self._run_group(g, k, scorer)

    def _run_group(self, g: Group, k: int, scorer: str):
        seal.record(g.variant)
        a = {n: self._put(v) for n, v in g.arrays.items()}
        if g.kind in ("flat", "fused"):
            return (*exact_window_topk(*self._score_tiles(g, a, scorer), k),
                    None)
        if g.kind == "lazyph":
            return self._run_lazyph(g, a, k, scorer)
        if g.kind == "lazyhost":
            return (*self._run_lazyhost(g, a, k, scorer), None)
        if g.kind == "posph":
            B, W = g.B, self.seg.n_windows
            scores = self._posph_scores(g, a, scorer)
            rmax = scores.reshape(B, W, NSUB, SUB_DOCS).amax(dim=3)
            return (*exact_window_topk(
                scores, rmax[..., None].expand(B, W, NSUB, TILE), k), None)
        run = {"dense": self._dense_scores, "phrase": self._compound_scores}
        scores = run[g.kind](g, a, scorer)
        return (*topk_lowest_index(scores.reshape(g.B, -1), k), None)

    def _score_tiles(self, g: Group, a: dict, scorer: str):
        """A flat (K2) or fused (K3) group's score tiles (B, W, 128, 128)
        and sub-block maxima."""
        seg = self.seg
        if g.kind == "flat":
            return fused_flat_score_tiles(
                self.bmeta, self.planes, a["cs"], a["cn"], a["weights"],
                a["flags"], a["kmin"], a["cids"], self.tf_planes, seg.n_docs,
                self._deleted_tiles, scorer_name=scorer,
            )
        return fused_score_tiles(
            self.bmeta, self.planes, a["cs"], a["cn"], a["weights"],
            a["cids"], self.tf_planes, seg.n_docs, self._deleted_tiles,
            tape=g.tape, scorer_name=scorer,
        )

    def _live_docs(self):
        """(W, 16384) bool: inside the segment and not masked."""
        W = self.seg.n_windows
        gid = torch.arange(W * WINDOW_SIZE, device=self.device)
        live = gid < self.seg.n_docs
        if self._deleted is not None:
            live = live & ~self._deleted
        return live.reshape(W, WINDOW_SIZE)

    def _decode_batch(self, g: Group, a: dict, with_offsets=False):
        """Decode every cell of a group: (B, W, T, 16384) f32 freqs (and
        i32 hit offsets)."""
        W, B, T = self.seg.n_windows, g.B, g.T
        out = materialize_freq_tiles(self.bmeta, self.planes, a["cs"],
                                     a["cn"], with_offsets=with_offsets)
        view = lambda t: t.reshape(W, B, T, WINDOW_SIZE).transpose(0, 1)
        return tuple(map(view, out)) if with_offsets else view(out)

    def _dense_scores(self, g: Group, a: dict, scorer: str):
        """>8-slot tapes: decode every cell, evaluate the tape over the
        tiles in torch (the reference's _build_batch_fn): (B, W, 16384)
        scores, -inf outside the match."""
        B, T = g.B, g.T
        freq = self._decode_batch(g, a)
        wts = a["weights"]
        mask, score = eval_tape_tiles(
            g.tape, {s: freq[:, :, s] for s in range(T)},
            lambda i: wts[:, i].reshape(B, 1, 1), scorer,
        )
        return torch.where(mask & self._live_docs(), score, NEG_INF)

    # ------------------------------------------------------- phrase path
    def _member_weights(self, key, members, ctx) -> np.ndarray:
        """(B,) f32 weight of each member query's phrase node."""
        model, docs_cnt, df_of = ctx["model"], ctx["docs_cnt"], ctx["df_of"]
        return np.array(
            [model.weight([df_of(t) for t in plan.weight_terms[key[2]]],
                          docs_cnt) for _, plan in members],
            np.float32,
        )

    def _cell_tables(self, members, T: int):
        """(W, B*T) cell tables of a group's queries, T columns each."""
        seg = self.seg
        cs = np.zeros((seg.n_windows, len(members) * T), np.int32)
        cn = np.zeros_like(cs)
        for bi, (_, plan) in enumerate(members):
            c_s, c_n = compute_cells(
                seg, [seg.term_id(t) for t in plan.term_texts]
            )
            cs[:, bi * T : bi * T + plan.n_slots] = c_s
            cn[:, bi * T : bi * T + plan.n_slots] = c_n
        return cs, cn

    def _prep_phrase_pos(self, key, members, k, ctx) -> Optional[Group]:
        """Posmask group (the reference's ``_prep_phrase_pos``): the
        members' distinct terms, `memidx` (query, member) -> distinct term,
        and for each distinct term its posmask hot-cache row `cidx` (-1 when
        uncached) and its column `kcol` of the kernel's output. The cell
        tables hold the uncached terms only, with no bucket pad: the kernel
        writes no cell that nothing reads. None (the lazy path runs) when no
        member has a block and nothing is cached: the masks would all be
        zero. The reference also fell back on a DMA-bucket overflow; the
        CUDA kernel has no buckets (ops/posmask.py)."""
        seg = self.seg
        slots = key[1]
        K = len(slots)
        if k < 1 or K < 2:
            return None
        B = len(members)
        tid_index: dict = {}
        memidx = np.zeros((B, K), np.int32)
        for bi, (_, plan) in enumerate(members):
            for j, s in enumerate(slots):
                tid = seg.term_id(plan.term_texts[s])
                memidx[bi, j] = tid_index.setdefault(tid, len(tid_index))
        cidx = np.array([self._pos_hot.get(int(t), -1) for t in tid_index],
                        np.int32)
        kcol = np.cumsum(cidx < 0) - 1
        cs, cn = compute_cells(seg, [t for t, c in zip(tid_index, cidx)
                                     if c < 0])
        if not (cidx >= 0).any() and not cn.any():
            return None
        arrays = {"cs": cs, "cn": cn,
                  "weights": self._member_weights(key, members, ctx)}
        return Group("posph", key, members, K, B, arrays,
                     dict(memidx=memidx, cidx=cidx, kcol=kcol))

    def _posph_scores(self, g: Group, a: dict, scorer: str):
        """Position words of the group's terms (kernel, or the hot cache),
        every doc's phrase freq per query and its score (the reference's
        ``_build_phrase_pos_fused``): (B, W, 128, 128), -inf outside the
        match."""
        W, B, K, PW = self.seg.n_windows, g.B, g.T, self._pw_words
        cidx, kcol = g.ctx["cidx"], g.ctx["kcol"]
        masks = cache = None
        if (cidx < 0).any():
            masks = materialize_posmask_tiles(
                self.bmeta, self.planes, self.hit_pw, self.hit_off, a["cs"],
                a["cn"], PW,
            )  # (W, uncached terms, PW, 128, 128)
        if (cidx >= 0).any():
            cache = self.pos_planes
        member = lambda mi: (masks[:, int(kcol[mi])] if cidx[mi] < 0
                             else cache[:, int(cidx[mi])])
        dead = None if self._deleted is None else self._deleted.reshape(
            W, TILE, TILE)
        scores = torch.empty((B, W, TILE, TILE), device=self.device)
        with trace("exec.phrase"):
            for b in range(B):
                freq = phrase_freq_from_masks(
                    [member(mi) for mi in g.ctx["memidx"][b]], K, PW
                )  # (W, 128, 128)
                live = freq > 0
                if dead is not None:
                    live &= ~dead
                sc = score_tile(scorer, freq.to(torch.float32),
                                a["weights"][b])
                scores[b] = torch.where(live, sc, NEG_INF)
        return scores

    def _prep_phrase_lazy(self, key, members, k, ctx) -> Group:
        """Lazy group (the reference's ``_prep_phrase_lazy``): cell tables,
        weights, the C2 bucket covering the group's largest min-member df.
        Without device caps (no positions stream, or a member freq above
        the FCAP ladder) the group takes the host-verify route."""
        seg = self.seg
        slots = key[1]
        T = _pad_T(members[0][1].n_slots)
        cs, cn = self._cell_tables(members, T)
        arrays = {"cs": cs, "cn": cn,
                  "weights": self._member_weights(key, members, ctx)}
        fcaps = self._phrase_fcaps(tuple(p for _, p in members), (slots,))
        cfg = get_config()
        if fcaps is None or k < 1:
            return Group("lazyhost", key, members, T, len(members), arrays,
                         dict(ctx, C2=cfg.phrase_lazy_candidates))
        total_bound = 0
        for _, plan in members:
            dfs = []
            for s in slots:
                tid = seg.term_id(plan.term_texts[s])
                dfs.append(int(seg.term_df[tid]) if tid >= 0 else 0)
            total_bound = max(total_bound, min(dfs))
        C2 = _pick_c2(total_bound, cfg.phrase_lazy_candidates, k)
        # C2 >= every query's min-member df bounds its conjunction count:
        # no overflow, and the threshold search is skipped (ops/select.py)
        return Group("lazyph", key, members, T, len(members), arrays,
                     dict(ctx, C2=C2, fcaps=fcaps[0],
                          no_overflow=total_bound <= C2))

    def _member_tiles(self, g: Group, a: dict):
        """Decode a pure-phrase group: per member, (B, n) freqs and hit
        offsets over the whole segment, and bound = min member freq."""
        B, n = g.B, self.seg.n_windows * WINDOW_SIZE
        freq, offv = self._decode_batch(g, a, with_offsets=True)
        mf = [freq[:, :, s].reshape(B, n) for s in g.tape[1]]
        mo = [offv[:, :, s].reshape(B, n) for s in g.tape[1]]
        bound = mf[0]
        for f in mf[1:]:
            bound = torch.minimum(bound, f)  # 0 if any member is missing
        return mf, mo, bound.to(torch.int32)

    def _run_lazyph(self, g: Group, a: dict, k: int, scorer: str):
        """Exact top-C2 candidates by (min member freq desc, docid asc),
        verified on the device, scored, top-k, and a `resolved` flag: False
        when the conjunction overflowed C2 and the k-th score does not beat
        the best unpulled bound (the reference's
        ``_build_phrase_lazy_fused``)."""
        C2, fcaps = g.ctx["C2"], g.ctx["fcaps"]
        mf, mo, bound = self._member_tiles(g, a)
        ki, valid, tau, overflow = bound_select_candidates(
            bound, C2, vmax=min(fcaps), assume_no_overflow=g.ctx["no_overflow"]
        )
        pf = torch.stack([gather_cols(f, ki) for f in mf], -1).to(torch.int32)
        po = torch.stack([gather_cols(o, ki) for o in mo], -1)
        with trace("exec.phrase"):
            pfreq = verify_phrases_device(self.hit_pw, self.hit_off, valid,
                                          pf, po, fcaps)
        live = (pfreq > 0) & valid
        if self._deleted is not None:
            live &= ~self._deleted[ki.long()]
        w = a["weights"]
        score = score_tile(scorer, pfreq.to(torch.float32), w[:, None])
        # candidates lie in docid order: the stable top-k keeps docid-asc
        kk = min(k, C2)
        gv, gidx = topk_lowest_index(torch.where(live, score, NEG_INF), kk)
        gi = torch.gather(ki.long(), 1, gidx)
        if kk < k:  # C2 below k: resolves only without overflow
            gv = torch.nn.functional.pad(gv, (0, k - kk), value=NEG_INF)
            gi = torch.nn.functional.pad(gi, (0, k - kk))
        thresh = score_tile(scorer, tau.to(torch.float32), w)
        return gv, gi, ~overflow | (gv[:, k - 1] > thresh)

    def _run_lazyhost(self, g: Group, a: dict, k: int, scorer: str):
        """Lazy route without device caps (the reference's
        ``_run_phrase_lazy_batch`` host loop): candidates ranked on the
        device by bound, verified on the host with the numpy verifier in
        bound order, stopping once the k-th score strictly beats the next
        bound; an unresolved query reruns alone as a compound group."""
        seg, B = self.seg, g.B
        model = g.ctx["model"]
        C2 = g.ctx["C2"]
        get_metrics().count("phrase.host_verify")
        mf, mo, bound = self._member_tiles(g, a)
        kb, ki = topk_lowest_index(bound, min(C2, bound.shape[1]))
        overflow = ((bound > 0).sum(dim=1) > C2).cpu().numpy()
        gids, bounds = ki.cpu().numpy(), kb.cpu().numpy()
        pf = torch.stack([gather_cols(f, ki) for f in mf], -1).to(
            torch.int32).cpu().numpy()
        po = torch.stack([gather_cols(o, ki) for o in mo], -1).cpu().numpy()
        weights = g.arrays["weights"]
        out_v = np.full((B, k), NEG_INF, np.float32)
        out_i = np.zeros((B, k), np.int64)
        # the host verifier, and a fallback's own verification in it
        with trace("exec.phrase"):
            for bi, (_, plan) in enumerate(g.members):
                acc_v = np.zeros(0, np.float32)
                acc_i = np.zeros(0, np.int64)
                n_valid = int((bounds[bi] > 0).sum())
                resolved = n_valid == 0
                for c0 in range(0, n_valid, HOST_VERIFY_CHUNK):
                    hi = min(c0 + HOST_VERIFY_CHUNK, n_valid)
                    pfreq = verify_phrase_candidates(
                        seg.positions, np.ones(hi - c0, bool), pf[bi, c0:hi],
                        po[bi, c0:hi],
                    )
                    gid = gids[bi, c0:hi]
                    keep = pfreq > 0
                    if self._deleted_np is not None:
                        keep &= ~self._deleted_np[gid]
                    sc = model.score_tile(
                        pfreq[keep].astype(np.float32), np.float32(weights[bi])
                    ).astype(np.float32)
                    acc_v = np.concatenate([acc_v, sc])
                    acc_i = np.concatenate([acc_i, gid[keep]])
                    order = np.lexsort((acc_i, -acc_v))[: 2 * k]
                    acc_v, acc_i = acc_v[order], acc_i[order]
                    if hi == n_valid:
                        # every pulled candidate verified: exact unless cut
                        resolved = not (bool(overflow[bi]) or n_valid >= C2)
                    elif len(acc_v) >= k:
                        nxt = float(model.score_tile(
                            np.float32(bounds[bi, hi]), np.float32(weights[bi])
                        ))
                        if nxt < acc_v[k - 1]:
                            resolved = True
                            break
                if not resolved:
                    acc_v, acc_i = self._dense_phrase_fallback(plan, g.ctx, k,
                                                               scorer)
                nkeep = min(len(acc_v), k)
                out_v[bi, :nkeep] = acc_v[:nkeep]
                out_i[bi, :nkeep] = acc_i[:nkeep]
        return self._put(out_v), self._put(out_i)

    def _finish_phrase_lazy(self, g: Group, gv, gi, resolved, k, scorer):
        """Rerun each unresolved query of a lazyph group alone (rare)."""
        gv, gi = gv.copy(), gi.copy()
        for bi, (_, plan) in enumerate(g.members):
            if not resolved[bi]:
                get_metrics().count("phrase.dense_fallback")
                with trace("exec.phrase"):
                    fv, fi = self._dense_phrase_fallback(plan, g.ctx, k,
                                                         scorer)
                nkeep = min(len(fv), k)
                gv[bi] = NEG_INF
                gv[bi, :nkeep] = fv[:nkeep]
                gi[bi, :nkeep] = fi[:nkeep]
        return gv, gi

    def _dense_phrase_fallback(self, plan, ctx, k, scorer):
        """One pure-phrase query as a compound group of one (every
        candidate verified): host (values, local ids). Its callers hold
        it inside an ``exec.phrase`` span, so its verification opens
        none."""
        g = self._prep_phrase_compound(plan.tape, [(0, plan)], ctx)
        seal.record(g.variant)
        a = {n: self._put(v) for n, v in g.arrays.items()}
        scores = self._compound_scores(g, a, scorer, span=False)
        gv, gi = topk_lowest_index(scores.reshape(1, -1), k)
        return gv[0].cpu().numpy(), gi[0].cpu().numpy()

    def _prep_phrase_compound(self, key, members, ctx) -> Group:
        """Compound group (the reference's ``_run_phrase_batch`` /
        ``_run_phrase``): cell tables, all weights, and the per-window
        candidate capacity C, an upper bound from block counts, so pass A
        never overflows. Device caps per phrase member, or None for the
        host verifier."""
        model, docs_cnt, df_of = ctx["model"], ctx["docs_cnt"], ctx["df_of"]
        plan0 = members[0][1]
        T = _pad_T(plan0.n_slots)
        phrase_slots = tuple(s for s, _ in collect_phrases(key))
        cs, cn = self._cell_tables(members, T)
        weights = np.array(
            [[model.weight([df_of(t) for t in terms], docs_cnt)
              for terms in plan.weight_terms] for _, plan in members],
            np.float32,
        ).reshape(len(members), len(plan0.weight_terms))
        C = _phrase_c_bucket(max(
            _phrase_c_bound(cn, phrase_slots, col=lambda s, b=bi: b * T + s)
            for bi in range(len(members))
        ))
        fcaps = self._phrase_fcaps(tuple(p for _, p in members), phrase_slots)
        return Group("phrase", key, members, T, len(members),
                     {"cs": cs, "cn": cn, "weights": weights},
                     dict(ctx, C=C, phrase_slots=phrase_slots, fcaps=fcaps))

    def _compound_scores(self, g: Group, a: dict, scorer: str,
                         span: bool = True):
        """Pass A (the first C member-conjunction candidates per window, in
        docid order), verification (device, or the numpy verifier; in an
        ``exec.phrase`` span unless `span` is False), pass C (the tape with
        the verified phrase-frequency tiles): (B, W, 16384) scores, -inf
        outside the match."""
        B, T = g.B, g.T
        freq, offv = self._decode_batch(g, a, with_offsets=True)
        C, fcaps = g.ctx["C"], g.ctx["fcaps"]
        if fcaps is None:
            get_metrics().count("phrase.host_verify")
        ptiles = []
        for p, slots in enumerate(g.ctx["phrase_slots"]):
            m = freq[:, :, slots[0]] > 0
            for s in slots[1:]:
                m = m & (freq[:, :, s] > 0)
            ki, valid = compact_mask(m.reshape(-1, WINDOW_SIZE), C)
            ki = ki.reshape(*m.shape[:2], C)
            valid = valid.reshape(ki.shape)
            pf = torch.stack([gather_cols(freq[:, :, s], ki) for s in slots],
                             -1).to(torch.int32)
            po = torch.stack([gather_cols(offv[:, :, s], ki) for s in slots],
                             -1)
            with (trace("exec.phrase") if span
                  else contextlib.nullcontext()):
                if fcaps is not None:
                    pfreq = verify_phrases_device(self.hit_pw, self.hit_off,
                                                  valid, pf, po, fcaps[p])
                else:
                    pfreq = self._put(verify_phrase_candidates(
                        self.seg.positions, valid.reshape(-1).cpu().numpy(),
                        pf.reshape(-1, len(slots)).cpu().numpy(),
                        po.reshape(-1, len(slots)).cpu().numpy(),
                    ).reshape(ki.shape))
            # invalid slots verify to 0: adding them changes nothing
            tile = torch.zeros(freq[:, :, 0].shape, device=self.device)
            ptiles.append(tile.scatter_add_(2, ki.long(),
                                            pfreq.to(torch.float32)))
        wts = a["weights"]
        mask, score = eval_tape_tiles(
            g.tape, {s: freq[:, :, s] for s in range(T)},
            lambda i: wts[:, i].reshape(B, 1, 1), scorer, ptiles,
        )
        return torch.where(mask & self._live_docs(), score, NEG_INF)

    def _term_max_freq(self, text: str) -> int:
        """Segment-wide max per-doc freq of a term (from block_max_freq)."""
        mf = self._max_freq_cache.get(text)
        if mf is None:
            seg = self.seg
            tid = seg.term_id(text)
            mf = 1
            if tid >= 0:
                s, n = int(seg.term_block_start[tid]), int(seg.term_nblocks[tid])
                if n:
                    mf = max(1, int(seg.block_max_freq[s : s + n].max()))
            self._max_freq_cache[text] = mf
        return mf

    def _phrase_fcaps(self, plans, phrase_slots):
        """Per-phrase member position caps for the device verifier, or None
        when a member's max freq exceeds the ladder or the segment has no
        positions stream (the host verifier runs)."""
        if len(self.seg.hit_group_off) < 2:
            return None
        caps = []
        for slots in phrase_slots:
            mem = []
            for s in slots:
                mf = max(self._term_max_freq(p.term_texts[s]) for p in plans)
                b = fcap_bucket(mf)
                if b is None:
                    return None
                mem.append(b)
            caps.append(tuple(mem))
        return tuple(caps)

    # -------------------------------------------------------------- batch
    def launch_batch(self, queries: Sequence, k: int = 10,
                     scorer: str = "bm25", stats=None, df_of=None):
        """Plan and launch a batch; returns a handle for finish_batch.
        Boolean and posmask groups return without waiting for the device."""
        get_metrics().count("search.queries", len(queries))
        return self.launch_groups(queries, k, scorer, stats, df_of)

    def launch_groups(self, queries: Sequence, k: int = 10,
                      scorer: str = "bm25", stats=None, df_of=None):
        """launch_batch without counting the queries (a mesh counts its
        batch once, not once per shard)."""
        t0 = time.perf_counter()
        tracer = get_tracer()
        batch = tracer.current_batch() or tracer.new_batch()
        with trace("exec.launch", batch=batch, source=self._serial):
            with trace("exec.prepare"):
                groups = self.plan_batch(queries, scorer, k, stats, df_of)
            outs = [self.run_group(g, k, scorer) for g in groups]
        return groups, outs, len(queries), k, scorer, t0, batch

    def finish_batch(self, handle) -> List[List[SearchResult]]:
        """Wait for a launch_batch handle and build the results (rerunning
        the rare unresolved lazy-phrase queries)."""
        groups, outs, n, k, scorer, t0, batch = handle
        results: List[List[SearchResult]] = [[] for _ in range(n)]
        if not groups:
            return results
        doc_map = self.seg.doc_map
        with trace("exec.finish", batch=batch):
            for qi, gv, gi in self._finished_rows(handle):
                res = []
                for v, i in zip(gv, gi):
                    if v == NEG_INF:
                        break
                    res.append(SearchResult(int(doc_map[i]), float(v)))
                results[qi] = res
        get_metrics().observe_us("search.batch_latency",
                                 (time.perf_counter() - t0) * 1e6)
        return results

    def finish_rows(self, handle) -> List[tuple]:
        """finish_batch's results before the doc map, for a mesh to merge
        its shards' rows: per query (scores f32, local docids int64), best
        first, -inf entries dropped."""
        empty = (np.zeros(0, np.float32), np.zeros(0, np.int64))
        results: List[tuple] = [empty] * handle[2]
        with trace("exec.finish", batch=handle[6]):
            for qi, gv, gi in self._finished_rows(handle):
                # the row ends at its first -inf
                stop = np.flatnonzero(gv == NEG_INF)
                end = stop[0] if len(stop) else len(gv)
                results[qi] = (gv[:end], gi[:end].astype(np.int64))
        return results

    def _finished_rows(self, handle):
        """(query index, score row, local docid row) of every member of a
        launch_batch handle's groups, after the wait for the device and
        the lazy-phrase reruns."""
        groups, outs, n, k, scorer = handle[:5]
        if not groups:
            return
        with trace("exec.device"):
            vals = torch.cat([o[0] for o in outs]).cpu().numpy()
            ids = torch.cat([o[1] for o in outs]).cpu().numpy()
            flags = [o[2] for o in outs if o[2] is not None]
            resolved = torch.cat(flags).cpu().numpy() if flags else None
        row = frow = 0
        for g, o in zip(groups, outs):
            gv, gi = vals[row : row + g.B], ids[row : row + g.B]
            row += g.B
            if o[2] is not None:
                gv, gi = self._finish_phrase_lazy(
                    g, gv, gi, resolved[frow : frow + g.B], k, scorer
                )
                frow += g.B
            for bi, (qi, _) in enumerate(g.members):
                yield qi, gv[bi], gi[bi]
