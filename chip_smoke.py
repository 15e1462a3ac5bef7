"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --profile   # where the time goes, instead
    python3 chip_smoke.py --turns PARENT_TREE   # two trees, in turns

Runs from the repo root and needs one CUDA card; it exits non-zero, with no
result line, when torch sees no card or the repo is not beside it. It
imports nothing of JAX and nothing of the JAX package (trinity_tpu): the
port stands alone, the corpus traffic and the baseline come from bench.py,
and the run fails if any trinity_tpu module was loaded.

Phases (each prints its own lines; any failure raises, so the exit code is
non-zero):

1. device: the card's name, compute capability and nvidia-smi power limit;
2. build: the CUDA kernels, compiled from trinity_tpu_torch/csrc with nvcc
   into trinity_tpu_torch/_build (git-ignored), with each kernel's
   registers, stack frame and spills from ptxas (the tape, flat and decode
   kernels must have neither stack nor spills), and the native host
   library, compiled from
   native/trinity_host.cpp into the same directory;
3. corpus and traffic: the bench deployment — bench.py's 1,048,576-doc,
   524,288-term corpus (bench's tokens and docs.bin, indexed by the port's
   own builder, cached under the build directory), its 120-query
   generator with seed SEED+1 (102 boolean queries, 12 bigram and 6
   trigram phrases), and the baseline engine (baseline/engine.cpp) on the
   same corpus;
4. each kernel against its plain torch version on the card, at the shapes
   the main path gives it (freq/offset tiles and position words
   bit-equal, scores and sub-block maxima within 2 ulp), with times
   (median of 5 rounds of 20 calls) taken three ways: CUDA events around
   20 calls launched back to back (cuda_ms; the plain version is timed so
   too), the device time from a CUDA graph of 20 calls with L2 flushed
   between them (graph_ms), and the host's time to enqueue a call
   (host_ms); and the bound (the bytes the call must move at the card's
   memory rate, or its f32 operations at the peak rate, the larger): K1
   on the first 8-term chunk of the hot-term planes (both output modes)
   and, with offsets, on the cells of the largest lazy phrase group (as
   use_posmask=False plans the 18 phrases) and on a pruned chunk (16
   gathered windows, one a duplicate with zeroed cells, half the queries
   of the largest flat pruned group resolved), K2 on each flat group (T = 2,
   4, 8), on one query alone (search()'s B = 1) and on phase 11's mesh
   shard 0's largest flat group (W = 16), K3 on the OR-of-AND group, K4 on
   the first 8-term chunk of the posmask hot cache and on the bigram and
   trigram groups' uncached cells, all over every window, and K5 on the
   bigram and trigram groups (their K4 words and the posmask hot cache);
5. the main path: Executor(seg, "cuda"), warmup, pipelined launch_batch /
   finish_batch QPS over the 120 queries and over each part (median of 3
   loops of 5 reps), blocking search() p50/p99 for each part (median of 3
   passes), top-10 parity against the baseline engine (must be 120/120),
   the kernels' launch counts (each > 0) and the port's device bytes;
6. the lazy phrase path: a second executor with use_posmask=False runs the
   18 phrases (parity 18/18, the decode kernel launched);
7. compound phrases: 4 queries built from the bench's phrase pairs
   ("a b" c, "a b" OR c, c NOT "a b", ("a b" c) OR d) on the card equal
   the port's CPU executor on the same segment (the baseline engine has
   no compound-phrase syntax);
8. the collection: generation 1 is the bench segment, generation 2 holds
   65,536 documents (57,344 updating base ids, 8,192 new ids), generation 3
   erases 8,192 further base ids and holds no document (build_generations;
   the generations and their merge are cached under the build directory).
   IndexSourcesCollection(device="cuda") must equal one executor over the
   merged segment searched with the collection's statistics on all 120
   queries (a), in match_ids on the 18 phrases and the 8 rarest boolean
   queries (b); search(doc_set=) on the base source must equal the CPU
   executor on 4 rare queries (c); search_pruned_batch must equal
   search_batch on the 102 boolean queries, on a base executor and on the
   collection, with its rounds printed beside a full scan's (d); under a
   byte budget below the searchable sources' segment bytes two passes must
   evict and stay equal to (a) (e); every kernel must launch in the phase
   (f). It prints the collection's pipelined QPS and search() p50/p99, the
   merge's seconds and each source's device bytes;
9. rich-match, intersect and the seal: exec_rich on the card must deliver
   the CPU executor's callback stream (doc ids ascending, each matched
   term's freq and hit positions) on the 18 phrases, the 8 rarest boolean
   queries and phase 7's 4 compound queries, its ids equal to match_ids
   (a stream longer than RICH_STREAM_CAP is compared over its first
   RICH_STREAM_CAP matches: the per-match loop is Python) (a); on the
   boolean query with the most matches a callback that raises AbortSearch
   after RICH_ABORT_AT matches must get exactly the first RICH_ABORT_AT ids
   of match_ids, with the device pass's time (CUDA events), its candidate
   C and the host's time per 1,000 matches printed (b); phase 8's
   collection's exec_rich must deliver each source's match_ids in order,
   whose union is the collection's (c); intersect on the card must equal
   the CPU executor's for the longest boolean query's 8 terms and the 64
   mix terms of lowest df (d); warmup(threads=8) on a fresh executor must
   build each hot cache once, and after seal_programs(strict=True) the
   120-query mix, pipelined and blocking, must record no new variant,
   with warmup's seconds at threads=8 and 1 printed (e); the decode
   kernel must launch in (a)-(d) (f). Phase 4 times K1 on this phase's
   two new shapes too (rich-match's cells with offsets; intersect at
   T = 64);
10. the percolator (BASELINE config #4) at tools/measure_percolator.py's
   two deployments (its query and document generators, same seeds, and
   its host_eval, copied here): 5,000 registered queries (40% AND of 2-3
   terms, 25% OR, 15% NOT, 10% 2-of-4, 10% phrase bigrams and trigrams,
   Zipf s = 1.07 over 3,000 terms) against 8 batches of 2,048 documents of
   40-80 tokens, then 50,000 queries against 8 batches of 512. The card's
   matrix must equal the numpy postfix evaluation of the same packed
   programs on every batch, the port's CPU run on batch 0, and
   match_stream must equal match_batch; it prints docs/s (match_stream),
   batch p50/p99 (match_batch), the registration's seconds, the device
   evaluation's ms (CUDA events, upload included) against the host
   incidence's ms, the host denominator's docs/s and the peak device
   bytes;
11. the mesh (BASELINE config #5): the bench segment split into 4 shards
   of 16 windows (split_segment, before phase 4, which times K2 on shard
   0's largest flat group as the mesh plans it), MeshExecutor over them,
   all on the one card. Its first launch_batch / finish_batch over the 120
   queries, with the kernel counts zeroed just before it and read just
   after (the mesh path's launches), must match the baseline engine's
   top-10 on 120/120, with ids and scores bit-equal to phase 5's executor
   (a), and every shard's executor must launch K1-K4 in it (g); under a
   mask of every
   7th global docid, equal to a single executor with the same mask (b);
   search_pruned_batch equal to search_batch on the 102 boolean queries
   (c); match_ids and exec_rich equal to the single executor's on the 18
   phrases and the 8 rarest boolean queries (d); a MeshSourcesCollection
   of phase 8's three generations (the erase-only one as four empty
   shards) equal to phase 8's collection, ids exactly and scores within
   2 ulp (e); after its warmup, a strict seal with 0 misses over the mix
   (f). It prints the split's seconds and the mesh's QPS and search()
   p50/p99 beside phase 5's.

The last lines: the check that no trinity_tpu module was loaded, one JSON
object {"kernels": [...]} (launches: phase 5's main path; mesh_launches:
phase 11's first mesh batch), the nvidia-smi line (name, power limit), and {"ok": true,
"device": {...}}.

With --profile it runs phases 1-3 and then, in place of 4-8, the
measurement behind PERF.md's "Where the time goes": the host split of a
blocking batch, the device busy share of pipelined batches and their top
kernels (torch.profiler), and each group's device time by function (CUDA
events), on the posmask and the lazy phrase paths. It prints no result
line.

With --turns PARENT_TREE (an unpacked older tree of this repo, e.g. from
git archive, with the same corpus builder output) it runs phases 1-2, the
corpus, and then, with the parent tree's port and with this one, each in
its own process, in turns (parent, this, this, parent) on the same card:
phase 5's end-to-end numbers, and phase 4's kernel calls timed in each of
the three ways; it prints each number's medians. It prints no result
line.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(REPO, "trinity_tpu_torch", "_build")
RTOL = 2.4e-7  # 2 ulp: the repo's engine-vs-oracle score bound
REPS = 20  # calls a timing round launches back to back
FLUSH_BYTES = 256 << 20  # written between two graph-timed calls: 5x the L2


def log(msg):
    print(msg, flush=True)


def nvidia_smi():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    cc = torch.cuda.get_device_capability(0)
    log(f"[device] {torch.cuda.get_device_name(0)} sm_{cc[0]}{cc[1]} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda} python={sys.version.split()[0]}")
    log(f"[device] nvidia-smi: {nvidia_smi()}")


def ptxas_report(log):
    """{kernel: [registers, stack frame, spill stores, spill loads]} from
    nvcc's -Xptxas -v output (template arguments shown as <4,8>)."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )_Z\w*?([a-z_]+_kernel)(I(?:Li\d+E)+E)?", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(2) or "")
            fn = m.group(1) + (f"<{','.join(args)}>" if args else "")
            out.setdefault(fn, [0, 0, 0, 0])
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out[fn][1:] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn][0] = int(m.group(1))
    return out


# kernels whose ptxas report must show no stack frame and no spills
NO_STACK_KERNELS = ("tape_score_kernel", "flat_score_kernel",
                    "decode_tiles_kernel")


def stack_faults(report):
    """What fails the ptxas check of a report (ptxas_report): each kernel
    of NO_STACK_KERNELS that it lacks (-> None), and each instance of one
    that keeps a stack frame or spills (-> its row)."""
    base = lambda fn: fn.split("<")[0]
    bad = {k: None for k in NO_STACK_KERNELS
           if not any(base(fn) == k for fn in report)}
    bad.update({fn: v for fn, v in report.items()
                if base(fn) in NO_STACK_KERNELS and any(v[1:])})
    return bad


def phase_build():
    from trinity_tpu_torch.utils import kernels

    kernels.load()
    info = kernels.build_info
    log(f"[build] kernels {info['seconds']:.2f}s -> "
        f"{os.path.relpath(info['path'], REPO)}")
    report = ptxas_report(info["log"])
    for fn, (regs, stack, st, ld) in sorted(report.items()):
        log(f"[build]   {fn}: {regs} registers, {stack} bytes stack frame, "
            f"{st}/{ld} bytes spill stores/loads")
    bad = stack_faults(report)
    if info["log"] and bad:
        raise RuntimeError(f"missing from ptxas, or keeps a stack or "
                           f"spills: {bad}")
    # native host library (index build): compiled here for this host's
    # CPU rather than loading the committed binary
    lib = os.path.join(BUILD, "libtrinity_host.so")
    t0 = time.perf_counter()
    subprocess.run(
        ["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o", lib,
         os.path.join(REPO, "native", "trinity_host.cpp")],
        check=True,
    )
    os.environ["TRINITY_HOST_LIB"] = lib
    log(f"[build] native host lib {time.perf_counter() - t0:.2f}s")


def build_corpus():
    """The bench deployment's corpus, built by the port: the tokens of
    bench.py's corpus builder (bench's constants, default_rng(bench.SEED)),
    the same docs.bin (read by baseline/engine.cpp and bench.make_queries),
    and the segment from the port's SegmentIndexSession.bulk_index_ids,
    persisted under bench._cache_dir()."""
    import numpy as np

    import bench
    from trinity_tpu_torch import SegmentIndexSession

    rng = np.random.default_rng(bench.SEED)
    zipf = 1.0 / np.arange(1, bench.VOCAB + 1) ** bench.ZIPF_S
    zipf /= zipf.sum()
    lengths = rng.integers(bench.DOC_LEN[0], bench.DOC_LEN[1],
                           size=bench.N_DOCS)
    bounds = np.zeros(bench.N_DOCS + 1, np.int64)
    np.cumsum(lengths, out=bounds[1:])
    tokens = rng.choice(bench.VOCAB, size=int(bounds[-1]), p=zipf).astype(
        np.uint32)
    os.makedirs(bench._cache_dir(), exist_ok=True)
    tmp = bench._docs_bin() + ".tmp"
    with open(tmp, "wb") as f:
        f.write(b"TBC1")
        np.array([bench.N_DOCS, bench.VOCAB], np.uint32).tofile(f)
        bounds.tofile(f)
        tokens.tofile(f)
    os.replace(tmp, bench._docs_bin())
    sess = SegmentIndexSession()
    sess.bulk_index_ids(np.arange(bench.N_DOCS), tokens.astype(np.int64),
                        bounds, [f"w{i}" for i in range(bench.VOCAB)])
    seg = sess.commit()
    seg.persist(os.path.join(bench._cache_dir(), "seg"))
    return seg


def reference_modules():
    """Loaded modules of the JAX package: trinity_tpu, trinity_tpu.*."""
    return sorted(m for m in sys.modules
                  if m == "trinity_tpu" or m.startswith("trinity_tpu."))


def load_corpus():
    """The bench corpus (built by the port on first use, under the build
    directory) and its 120 queries: (seg, queries, id_lines)."""
    import numpy as np

    import bench
    from trinity_tpu_torch import SegmentData

    bench.CACHE_ROOT = os.path.join(BUILD, "bench_seg")
    t0 = time.perf_counter()
    seg_dir = os.path.join(bench._cache_dir(), "seg")
    if not os.path.exists(os.path.join(seg_dir, "id")):
        # the port's builder, in a subprocess (its memory and CPU churn
        # stay out of this process), writing under the build dir
        code = ("import bench, chip_smoke; "
                f"bench.CACHE_ROOT = {bench.CACHE_ROOT!r}; "
                "chip_smoke.build_corpus(); "
                "assert not chip_smoke.reference_modules(), "
                "chip_smoke.reference_modules()")
        subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
    seg = SegmentData.load(seg_dir)
    log(f"[corpus] {seg.n_docs} docs, {seg.n_terms} terms, "
        f"{seg.n_windows} windows, built by trinity_tpu_torch, ready in "
        f"{time.perf_counter() - t0:.1f}s")
    queries, id_lines = bench.make_queries(
        seg, np.random.default_rng(bench.SEED + 1)
    )
    return seg, queries, id_lines


def phase_corpus():
    import bench

    seg, queries, id_lines = load_corpus()
    t0 = time.perf_counter()
    base = bench.measure_baseline(id_lines)
    if base is None:
        raise RuntimeError("baseline engine failed to build or run")
    base_topk = bench.load_topk_dump(base["topk_path"])
    phrase = [line.startswith("P") for line in id_lines]
    log(f"[corpus] baseline engine {base['qps']:.1f} qps single-core "
        f"({time.perf_counter() - t0:.1f}s); traffic {len(queries)} "
        f"queries ({sum(phrase)} phrases)")
    return seg, queries, base_topk, phrase


def cuda_ms(fn, rounds=5):
    """Device ms of one call of `fn`: after a warm call, `rounds` rounds of
    REPS calls launched back to back between two CUDA events; the median
    round over REPS. Back to back, the card runs one call after the other
    while the host enqueues the next, so the host's own time per call
    (the wrapper's checks and the launch) is hidden wherever it is below
    the call's device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(REPS):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / REPS)
    return sorted(times)[len(times) // 2]


def graph_ms(fn, rounds=5):
    """Device ms of one call of `fn`, without its host time and from a cold
    L2: REPS calls captured in one CUDA graph, each after a write of
    FLUSH_BYTES that evicts from L2 what the call before it left there,
    less a graph of the REPS writes alone; both replayed between CUDA
    events, the median of `rounds` differences over REPS. The wrapper's
    checks, allocation and launch run while the graph is captured, not
    while it is timed (host_ms counts them). The main path never runs a
    kernel twice on the same data back to back (K1 fills the next part of
    the hot-term planes each call), so each call starts from a cold L2."""
    import torch

    fn()
    torch.cuda.synchronize()
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")

    def captured(body):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(REPS):
                body()
        g.replay()
        return g

    graphs = (captured(lambda: (buf.zero_(), fn())), captured(buf.zero_))
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t = []
        for g in graphs:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            g.replay()
            e.record()
            e.synchronize()
            t.append(s.elapsed_time(e))
        times.append((t[0] - t[1]) / REPS)
    del graphs
    return sorted(times)[len(times) // 2]


def host_ms(fn, rounds=5):
    """Host ms of one call of `fn`: REPS calls enqueued on an idle card, on
    the host's clock, without waiting for the card (the wrapper's checks,
    allocation and launch); the median of `rounds` rounds over REPS."""
    import torch

    fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(REPS):
            fn()
        times.append((time.perf_counter() - t) * 1e3 / REPS)
    torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


# the three ways a kernel call is timed (phase 4 and --turns)
TIMERS = {"cuda": cuda_ms, "graph": graph_ms, "host": host_ms}


def compare(got, want, exact):
    """Max abs error and max ulp distance over finite entries; -inf (and,
    when exact, every entry) must match."""
    import torch

    err = ulp = 0.0
    for g, w in zip(got, want):
        if exact:
            if not torch.equal(g, w):
                raise RuntimeError("kernel output is not bit-equal")
            continue
        if not torch.equal(torch.isinf(g), torch.isinf(w)):
            raise RuntimeError("kernel -inf positions differ")
        fin = torch.isfinite(w)
        g, w = g[fin].double(), w[fin].double()
        if g.numel():
            step = (torch.nextafter(w.abs().float(),
                                    torch.tensor(float("inf"), device=w.device))
                    .double() - w.abs())
            err = max(err, (g - w).abs().max().item())
            ulp = max(ulp, ((g - w).abs() / step).max().item())
    if ulp > 2:
        raise RuntimeError(f"kernel differs by {ulp} ulp (> 2)")
    return err, ulp


def kernel_cases(ex, queries):
    """The main path's shapes for each kernel, as (kernel, what, call,
    plain call, byte-count call, detail call) for the executor `ex`: K1 on
    the first 8-term chunk of the hot-term planes (both output modes) and
    on the largest lazy phrase group's cells; K2 on each flat group,
    the largest first, then on one query alone (search()'s B = 1); K3 on
    the OR-of-AND group; K4 on the first 8-term
    chunk of the posmask hot cache and on the bigram and trigram groups'
    uncached cells (all windows). The calls take no argument; call and
    `what` use only what the port had before this file's turns mode (so it
    can time an older tree too)."""
    import torch

    from trinity_tpu_torch.ops import posmask as pm
    from trinity_tpu_torch.ops import postings as po

    seg = ex.seg
    put = lambda a: torch.from_numpy(a).to(ex.device)
    cases = []
    tids = sorted(ex._hot, key=ex._hot.get)[:8]
    cs, cn = map(put, po.compute_cells(seg, tids))
    for off in (False, True):
        a = (ex.bmeta, ex.planes, cs, cn)
        cases.append((
            "decode", f"T=8, {int(cn.sum())} blocks, offsets {off}",
            lambda a=a, o=off: po.materialize_freq_tiles(*a, with_offsets=o),
            lambda a=a, o=off: po.materialize_freq_tiles_ref(
                *a, with_offsets=o),
            lambda a=a, o=off: po.decode_bytes(a[0], a[2], a[3], o),
            lambda: ""))
    for what, cells, off in slice_k1_cells(seg, queries):
        a = (ex.bmeta, ex.planes, *map(put, cells))
        cases.append((
            "decode", f"{what}, {int(cells[1].sum())} blocks, offsets {off}",
            lambda a=a, o=off: po.materialize_freq_tiles(*a, with_offsets=o),
            lambda a=a, o=off: po.materialize_freq_tiles_ref(
                *a, with_offsets=o),
            lambda a=a, o=off: po.decode_bytes(a[0], a[2], a[3], o),
            lambda: ""))
    g = largest_lazy_group(seg, queries)
    a = (ex.bmeta, ex.planes, put(g.arrays["cs"]), put(g.arrays["cn"]))
    cases.append((
        "decode", f"lazy group B={g.B}, T={g.T}, {int(g.arrays['cn'].sum())} "
        f"blocks, offsets True",
        lambda a=a: po.materialize_freq_tiles(*a, with_offsets=True),
        lambda a=a: po.materialize_freq_tiles_ref(*a, with_offsets=True),
        lambda a=a: po.decode_bytes(a[0], a[2], a[3], True),
        lambda: ""))
    chunk = pruned_chunk(ex, queries)
    if chunk is not None:  # an older tree (--turns) has no pruned search
        what, selp, csel, nsel = chunk
        a = (ex.bmeta, ex.planes, put(csel), put(nsel), put(selp))
        cases.append((
            "decode", what,
            lambda a=a: po.materialize_freq_tiles(*a),
            lambda a=a: po.materialize_freq_tiles_ref(*a),
            lambda a=a: po.decode_bytes(a[0], a[2], a[3], False),
            lambda: ""))
    groups = ex.plan_batch(queries)
    flats = sorted((g for g in groups if g.kind == "flat"),
                   key=lambda g: -g.B * g.T)
    # search() of one query: the largest group's first, alone (B = 1)
    flats += ex.plan_batch([queries[flats[0].members[0][0]]])
    fused = next(g for g in groups if g.kind == "fused")
    for g, key in [(g, "flat") for g in flats] + [(fused, "tape")]:
        cases.append(score_case(ex, g, key))
    PW = ex._pw_words
    tids = sorted(ex._pos_hot, key=ex._pos_hot.get)[:8]
    sources = [("hot chunk", po.compute_cells(seg, tids))]
    for T, name in ((2, "bigram group"), (3, "trigram group")):
        g = next(g for g in groups if g.kind == "posph" and g.T == T)
        sources.append((name, (g.arrays["cs"], g.arrays["cn"])))
    for what, (cs, cn) in sources:
        args = (ex.bmeta, ex.planes, ex.hit_pw, ex.hit_off, put(cs), put(cn),
                PW)
        cases.append((
            "posmask", f"{what}: M={cs.shape[1]}, PW={PW}, "
            f"{int(cn.sum())} blocks",
            lambda a=args: pm.materialize_posmask_tiles(*a),
            lambda a=args: pm.materialize_posmask_tiles_ref(*a),
            lambda a=args: pm.posmask_bytes(a[0], a[1], a[3], a[4], a[5],
                                            a[6]),
            lambda a=args: f"{position_elements(*a[:2], *a[4:6])} position "
                           f"elements"))
    if hasattr(pm, "phrase_score_tiles"):  # an older tree (--turns) has no K5
        for T, name in ((2, "bigram group"), (3, "trigram group")):
            cases.append(phrase_case(ex, next(
                g for g in groups if g.kind == "posph" and g.T == T), name))
    return cases


def phrase_case(ex, g, name):
    """The phase-4 case of K5 on posmask group `g`: its uncached members'
    words made once by K4, its cached members read from the hot cache."""
    import torch

    from trinity_tpu_torch.ops import posmask as pm

    put = lambda a: torch.from_numpy(a).to(ex.device)
    cidx = g.ctx["cidx"]
    masks = pm.materialize_posmask_tiles(
        ex.bmeta, ex.planes, ex.hit_pw, ex.hit_off, put(g.arrays["cs"]),
        put(g.arrays["cn"]), ex._pw_words) if (cidx < 0).any() else None
    cache = ex.pos_planes if (cidx >= 0).any() else None
    args = (masks, cache, put(g.arrays["members"]), put(g.arrays["weights"]),
            None)
    return (
        "phrase", f"{name}: B={g.B}, K={g.T}, PW={ex._pw_words}, "
        f"{int((cidx < 0).sum())} uncached and {int((cidx >= 0).sum())} "
        f"cached members",
        lambda a=args: pm.phrase_score_tiles(*a, scorer_name="bm25"),
        lambda a=args: pm.phrase_score_tiles_ref(*a, scorer_name="bm25"),
        lambda a=args: pm.phrase_score_bytes(a[0], a[1], a[2], a[4]),
        lambda: "")


PRUNED_CHUNK = 16  # search_pruned_batch's default chunk_windows
INTERSECT_WIDE = 64  # tokens of phase 9's wide intersect: the most it takes


def query_terms(q):
    """The term texts of a query's plan (its slots, in slot order)."""
    from trinity_tpu_torch import parse_query
    from trinity_tpu_torch.plan.compile import compile_plan

    return compile_plan(parse_query(q).root).term_texts


def longest_boolean(queries):
    """The non-phrase query with the most slots (the first such)."""
    qs = [q for q in queries if '"' not in q]
    return max(qs, key=lambda q: len(query_terms(q)))


def wide_intersect_terms(seg, queries, n=INTERSECT_WIDE):
    """The `n` distinct terms of the mix with the lowest df. Not the
    highest: the 64 hottest terms give nearly every document its own mask
    (~1M distinct masks), and intersect's dominance filter (the
    reference's, a pairwise scan) is quadratic in the distinct masks."""
    terms = {t for q in queries for t in query_terms(q)}
    df = lambda t: int(seg.term_df[seg.term_id(t)])
    return sorted(terms, key=lambda t: (df(t), t))[:n]


def slice_k1_cells(seg, queries):
    """K1's inputs on phase 9's paths: (what, (cell starts, cell counts),
    with_offsets) for rich-match's device pass on the mix's longest
    boolean query (T = its padded slots, hit offsets) and for intersect
    over the INTERSECT_WIDE mix terms of lowest df (T = 64, no offsets);
    every window."""
    import numpy as np

    from trinity_tpu_torch.exec.planning import _pad_T
    from trinity_tpu_torch.ops.postings import compute_cells

    out = []
    q = longest_boolean(queries)
    texts = query_terms(q)
    cs, cn = compute_cells(seg, [seg.term_id(t) for t in texts])
    pad = ((0, 0), (0, _pad_T(len(texts)) - len(texts)))
    out.append((f"rich-match {q!r}: T={_pad_T(len(texts))}",
                (np.pad(cs, pad), np.pad(cn, pad)), True))
    toks = wide_intersect_terms(seg, queries)
    out.append((f"intersect of the {len(toks)} mix terms of lowest df: "
                f"T={len(toks)}",
                compute_cells(seg, [seg.term_id(t) for t in toks]), False))
    return out


def pruned_chunk(ex, queries):
    """The decode kernel's input on a pruned chunk (exec/pruned.py), or
    None when the tree has no pruned search: the largest flat group that
    search_pruned_batch forms from the boolean queries, its last
    PRUNED_CHUNK - 1 windows in bound order padded by a duplicate of one of
    them (cells zeroed), every other query resolved (cells zeroed). Returns
    (description, window_base, cell starts, cell counts)."""
    import numpy as np

    try:
        from trinity_tpu_torch.exec import pruned
    except ImportError:
        return None
    groups, _ = pruned.plan_pruned(ex, ex._parse(queries), "bm25")
    g = max((g for g in groups if g.key[0] == "flat"),
            key=lambda g: g.B * g.T)
    resolved = np.zeros(g.B, bool)
    resolved[1::2] = True  # every other query (and the padding rows)
    resolved[len(g.members):] = True
    c0 = ex.seg.n_windows - (PRUNED_CHUNK - 1)
    selp, csel, nsel = pruned.chunk_cells(g, c0, PRUNED_CHUNK, resolved)
    what = (f"pruned chunk: M={len(selp)} gathered windows "
            f"({len(set(selp.tolist()))} distinct), B={g.B} with "
            f"{len(g.members)} queries ({int(resolved[:len(g.members)].sum())}"
            f" resolved), T={g.T}, {int(nsel.sum())} blocks, offsets False")
    return what, selp, csel, nsel


def largest_lazy_group(seg, queries):
    """The lazy phrase group (use_posmask=False) with the most cells, then
    the most postings blocks: its cell tables are what _decode_batch
    decodes, with offsets. Planned by a CPU executor (planning is host
    work)."""
    from trinity_tpu_torch import Executor, configure, get_config

    saved = get_config().use_posmask
    configure(use_posmask=False)
    try:
        groups = Executor(seg, device="cpu").plan_batch(queries)
    finally:
        configure(use_posmask=saved)
    lazy = [g for g in groups if g.kind == "lazyph"]
    return max(lazy, key=lambda g: (g.B * g.T, int(g.arrays["cn"].sum())))


def program_size(tape):
    """The tape kernel's register program for `tape` (None: a flat group,
    which has none), as text."""
    from trinity_tpu_torch.ops import fusedscore as fs

    if tape is None:
        return ""
    prog, nreg = fs.encode_tape(tape, fs.tape_used_slots(tape))
    return f"program of {len(prog)} ops in {nreg} registers"


def score_case(ex, g, key, where=""):
    """The phase-4 case of K2 (key "flat") or K3 ("tape") on group `g` of
    executor `ex`: (kernel, what, call, plain call, byte-count call,
    detail call)."""
    import torch

    from trinity_tpu_torch.ops import fusedscore as fs

    seg = ex.seg
    a = {n: torch.from_numpy(v).to(ex.device) for n, v in g.arrays.items()}
    head = (ex.bmeta, ex.planes, a["cs"], a["cn"], a["weights"])
    what = (f"{where}B={g.B} with {len(g.members)} queries, T={g.T}, "
            f"{int((g.arrays['cids'] >= 0).sum())} cached slots")
    if key == "flat":
        tail = (a["flags"], a["kmin"], a["cids"], ex.tf_planes,
                seg.n_docs, None)
        call = lambda h=head, t=tail: fs.fused_flat_score_tiles(
            *h, *t, scorer_name="bm25")
        ref = lambda h=head, t=tail: fs.fused_flat_score_tiles_ref(
            *h, *t, scorer_name="bm25")
        nw = 2 * g.T + 1
    else:
        tail = (a["cids"], ex.tf_planes, seg.n_docs, None)
        call = lambda h=head, t=tail, tp=g.tape: fs.fused_score_tiles(
            *h, *t, tape=tp, scorer_name="bm25")
        ref = lambda h=head, t=tail, tp=g.tape: fs.fused_score_tiles_ref(
            *h, *t, tape=tp, scorer_name="bm25")
        nw = g.arrays["weights"].shape[1]
    nb = lambda a=a, B=g.B, nw=nw: fs.score_bytes(
        ex.bmeta, ex.planes, a["cs"], a["cn"], a["cids"], B, None, nw)
    return key, what, call, ref, nb, lambda tp=g.tape: program_size(tp)


def shard_cases(mex, queries):
    """K2 on one mesh shard's largest flat group, as the mesh plans it
    (shard 0's executor, the mesh's statistics): phase 11's shape."""
    ex = mex.executors[0]
    groups = ex.plan_batch(queries, "bm25", 10, *mex._stats(None, None))
    g = max((g for g in groups if g.kind == "flat"),
            key=lambda g: g.B * g.T)
    return [score_case(ex, g, "flat", where=f"mesh shard 0 of "
                       f"{len(mex.shards)}, W={ex.seg.n_windows}: ")]


def position_elements(bmeta, planes, cs, cn):
    """Position elements of the cells' in-window postings (the positions a
    posmask call ORs in): the sum of their freqs."""
    from trinity_tpu_torch.limits import WINDOW_SIZE
    from trinity_tpu_torch.ops.postings import decode_cells

    cell, docs, freq, _, valid = decode_cells(bmeta, planes, cs, cn)
    local = docs - (cell // cs.shape[1])[:, None] * WINDOW_SIZE
    return int(freq[valid & (local >= 0) & (local < WINDOW_SIZE)].sum())


KERNEL_ROWS = {  # counter: (name, source, the TPU kernel it replaces)
    "decode": ("materialize_freq_tiles", "trinity_tpu_torch/csrc/postings.cu",
               "trinity_tpu/ops/postings.py:530"),
    "flat": ("fused_flat_score_tiles", "trinity_tpu_torch/csrc/fusedscore.cu",
             "trinity_tpu/ops/fusedscore.py:421"),
    "tape": ("fused_score_tiles", "trinity_tpu_torch/csrc/fusedscore.cu",
             "trinity_tpu/ops/fusedscore.py:378"),
    "posmask": ("materialize_posmask_tiles",
                "trinity_tpu_torch/csrc/posmask.cu",
                "trinity_tpu/ops/posmask.py:303"),
    "phrase": ("phrase_score_tiles", "trinity_tpu_torch/csrc/phrasescore.cu",
               "trinity_tpu/exec/executor.py:858 (XLA's fusion; no "
               "pallas_call)"),
}


def phase_kernels(seg, queries, shards):
    """Each kernel against its plain version at the main path's shapes
    (and K2 at a mesh shard's, from `shards`): integer tiles bit-equal,
    scores within 2 ulp; median times, and the bound from the bytes (and
    f32 operations) the call must move."""
    import torch

    from trinity_tpu_torch import Executor
    from trinity_tpu_torch.parallel import MeshExecutor
    from trinity_tpu_torch.utils import kernels

    ex = Executor(seg, device="cuda")
    mex = MeshExecutor(shards)  # every visible card: the one
    rows = {}
    for key, what, call, ref, nbytes, detail in (
            kernel_cases(ex, queries) + shard_cases(mex, queries)):
        got, want = call(), ref()
        torch.cuda.synchronize()
        pair = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        exact = key in ("decode", "posmask")
        err, ulp = compare(*pair, exact=exact)
        ms, dev_ms, host = (timer(call) for timer in TIMERS.values())
        plain = cuda_ms(ref)
        counted = nbytes()
        nb, ops = counted if isinstance(counted, tuple) else (counted, 0)
        bound, by = kernels.bound_ms(nb, ops)
        what = ", ".join(x for x in (what, detail()) if x)
        match = ("bit-exact" if exact
                 else f"max {ulp:.1f} ulp, abs err {err:.3g}")
        log(f"[kernels] {key} {KERNEL_ROWS[key][0]} ({what}): {match}"
            f"; {ms:.4f} ms back to back (device {dev_ms:.4f} ms, host "
            f"{host:.4f} ms) vs plain {plain:.4f} ms; bound {bound:.4f} ms "
            f"({nb} bytes, {ops} f32 ops: {by}), share {bound / ms:.3f} "
            f"(of the device time {bound / dev_ms:.3f})")
        # the first shape of each kernel is its row in the kernels line;
        # ms and plain_ms are both timed back to back (cuda_ms)
        rows.setdefault(key, dict(
            name=KERNEL_ROWS[key][0], source=KERNEL_ROWS[key][1],
            replaces=KERNEL_ROWS[key][2], max_abs_err=err, ms=ms,
            device_ms=dev_ms, host_ms=host,
            plain_ms=plain, bound_ms=bound, bound_by=by,
            # no single PyTorch call computes any of these functions
            library_ms=None))
    del ex, mex
    torch.cuda.empty_cache()
    return rows


def turn_times(root, cache_root, reps):
    """One turn of --turns, run in a fresh process: import the port from
    the tree at `root`, load the bench corpus cached under `cache_root`
    (bench.CACHE_ROOT), measure the main path end to end (slice_metrics),
    then time each kernel case `reps` times by each of TIMERS with that
    tree's kernels. Prints one JSON line {"slice": {metric: [x, ...]},
    timer: {case: [ms, ...]}, ...}."""
    import numpy as np

    sys.path.insert(0, root)
    import bench
    from trinity_tpu_torch import Executor, SegmentData

    bench.CACHE_ROOT = cache_root
    seg = SegmentData.load(os.path.join(bench._cache_dir(), "seg"))
    queries, id_lines = bench.make_queries(
        seg, np.random.default_rng(bench.SEED + 1))
    ex = Executor(seg, "cuda")
    ex.warmup(queries, k=10)
    out = {"slice": slice_metrics(
        ex, queries, [line.startswith("P") for line in id_lines])}
    cases = [(f"{key} {what}", call)
             for key, what, call, *_ in kernel_cases(ex, queries)]
    for _, call in cases:  # every case once: the card's clocks settle
        call()
    for _ in range(reps):  # the cases in turn, so drift spreads over all
        for name, call in cases:
            for timer, fn in TIMERS.items():
                out.setdefault(timer, {}).setdefault(name, []).append(
                    fn(call))
    print(json.dumps(out), flush=True)


def phase_turns(parent):
    """End-to-end numbers and kernel times of the tree at `parent` against
    this tree's, in one process each, in turns (parent, this, this,
    parent) on this card."""
    import numpy as np

    import bench

    load_corpus()
    runs = {}  # (table, row) -> {tag: [x, ...]}
    for tag, root in (("parent", parent), ("this", REPO), ("this", REPO),
                      ("parent", parent)):
        code = ("import importlib.util as u, sys; "
                f"s = u.spec_from_file_location('smoke', {__file__!r}); "
                "m = u.module_from_spec(s); s.loader.exec_module(m); "
                f"m.turn_times({os.path.abspath(root)!r}, "
                f"{bench.CACHE_ROOT!r}, 3)")
        r = subprocess.run([sys.executable, "-c", code], cwd=root,
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"turn of {root} failed:\n{r.stderr[-3000:]}")
        times = json.loads(r.stdout.strip().splitlines()[-1])
        log(f"[turns] {tag} ({root}): " + json.dumps(times))
        for table, rows in times.items():
            for row, xs in rows.items():
                runs.setdefault((table, row), {}).setdefault(tag, []).extend(
                    xs)
    for (table, row), by in runs.items():
        med = {tag: float(np.median(xs)) for tag, xs in by.items()}
        if "parent" not in med:  # a case the parent's port cannot run
            log(f"[turns] {table} {row}: this {med['this']:.4f}; medians of "
                f"{len(by['this'])}")
            continue
        log(f"[turns] {table} {row}: parent {med['parent']:.4f}, this "
            f"{med['this']:.4f} (parent/this {med['parent'] / med['this']:.2f}"
            f"); medians of {len(by['this'])} each")


def qps(ex, queries, reps=5):
    """Queries a second over `reps` pipelined launch_batch/finish_batch
    rounds (the next batch is launched before the last one is finished)."""
    t = time.perf_counter()
    h = ex.launch_batch(queries, k=10)
    for _ in range(reps - 1):
        nxt = ex.launch_batch(queries, k=10)
        ex.finish_batch(h)
        h = nxt
    ex.finish_batch(h)
    return reps * len(queries) / (time.perf_counter() - t)


def latency(ex, queries):
    """The p50 and p99 of blocking search(), ms, in each of 3 passes."""
    import numpy as np

    p50s, p99s = [], []
    for _ in range(3):
        lat = []
        for q in queries:
            t = time.perf_counter()
            ex.search(q, k=10)
            lat.append(time.perf_counter() - t)
        p50s.append(float(np.percentile(np.array(lat) * 1e3, 50)))
        p99s.append(float(np.percentile(np.array(lat) * 1e3, 99)))
    return p50s, p99s


def slice_metrics(ex, queries, phrase):
    """The main path's end-to-end numbers on a warm executor, each in 3
    runs: pipelined QPS over the mix and over its boolean and phrase
    parts (3 loops of 5 reps), and search() p50/p99 of each part (ms, 3
    passes). {metric: [x, x, x]}."""
    parts = {
        "boolean": [q for q, p in zip(queries, phrase) if not p],
        "phrase": [q for q, p in zip(queries, phrase) if p],
    }
    out = {"mix QPS": [qps(ex, queries) for _ in range(3)]}
    for name, qs in parts.items():
        out[f"{name} QPS"] = [qps(ex, qs) for _ in range(3)]
        out[f"{name} p50 ms"], out[f"{name} p99 ms"] = latency(ex, qs)
    return out


def parity(what, queries, base_topk, ours):
    """Top-10 agreement with the baseline engine; raises on a mismatch."""
    import bench

    bad = [i for i, (b, o) in enumerate(zip(base_topk, ours))
           if not bench.topk_agree(b, [(r.doc_id, r.score) for r in o])]
    log(f"[{what}] top-10 parity vs baseline engine "
        f"{len(queries) - len(bad)}/{len(queries)}")
    for i in bad:
        log(f"[{what}]   MISMATCH {queries[i]!r}: baseline {base_topk[i][:3]} "
            f"ours {[(r.doc_id, r.score) for r in ours[i][:3]]}")
    if bad:
        raise RuntimeError(f"{what}: top-10 parity failed on {len(bad)} queries")
    if sum(1 for o in ours if o) < len(queries) // 2:
        raise RuntimeError(f"{what}: most queries returned nothing")


def phase_slice(seg, queries, base_topk, phrase):
    import numpy as np
    import torch

    from trinity_tpu_torch import Executor
    from trinity_tpu_torch.utils import kernels

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()  # the peak below is the main path's
    t0 = time.perf_counter()
    ex = Executor(seg, device="cuda")
    w = ex.warmup(queries, k=10)
    log(f"[slice] executor + warmup of {len(queries)} queries "
        f"{time.perf_counter() - t0:.2f}s (warmup {w['seconds']:.2f}s)")
    m = slice_metrics(ex, queries, phrase)
    med = lambda k: float(np.median(m[k]))
    runs = lambda k: ", ".join(f"{x:.2f}" for x in m[k])
    log(f"[slice] QPS {med('mix QPS'):.2f} (loops {runs('mix QPS')}), "
        f"pipelined launch_batch/finish_batch, {len(queries)} queries x 5 "
        f"reps")
    for name in ("boolean", "phrase"):
        n = sum(1 for p in phrase if p == (name == "phrase"))
        log(f"[slice] {name} ({n} queries): QPS {med(f'{name} QPS'):.2f} "
            f"(loops {runs(f'{name} QPS')}); search() p50 "
            f"{med(f'{name} p50 ms'):.3f} ms, p99 {med(f'{name} p99 ms'):.3f}"
            f" ms (median of 3 passes)")
    ours = ex.search_batch(queries, k=10)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    parity("slice", queries, base_topk, ours)
    for name, flag in (("boolean", False), ("phrase", True)):
        n = sum(1 for p in phrase if p == flag)
        log(f"[slice]   {name}: {n}/{n}")
    log(f"[slice] kernel launches in the main path: {launches}")
    if not all(launches[k] > 0 for k in ("decode", "flat", "tape",
                                          "posmask", "phrase")):
        raise RuntimeError(f"a kernel of the path never launched: {launches}")
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    log(f"[slice] device bytes {ex.device_bytes_held} (segment "
        f"{nb(ex.bmeta, ex.planes)}, positions {nb(ex.hit_pw, ex.hit_off)}, "
        f"hot planes {nb(ex.tf_planes)} for {len(ex._hot)} terms, posmask "
        f"cache {nb(ex.pos_planes)} for {len(ex._pos_hot)} terms, PW "
        f"{ex._pw_words}); peak allocated {torch.cuda.max_memory_allocated()}")
    return launches, ours, m


def phase_lazy(seg, queries, base_topk, phrase):
    """The 18 phrases on the lazy path (use_posmask=False)."""
    import torch

    from trinity_tpu_torch import Executor, configure, get_config
    from trinity_tpu_torch.utils import kernels

    qs = [q for q, p in zip(queries, phrase) if p]
    base = [b for b, p in zip(base_topk, phrase) if p]
    torch.cuda.empty_cache()
    saved = get_config().use_posmask
    configure(use_posmask=False)
    try:
        kernels.reset_launches()
        ex = Executor(seg, device="cuda")
        t0 = time.perf_counter()
        ours = ex.search_batch(qs, k=10)
        first = time.perf_counter() - t0
        launches = dict(kernels.launches)
        t0 = time.perf_counter()
        ex.search_batch(qs, k=10)
        again = time.perf_counter() - t0
        kinds = sorted({g.kind for g in ex.plan_batch(qs)})
    finally:
        configure(use_posmask=saved)
    log(f"[lazy] {len(qs)} phrases as groups {kinds}: first batch "
        f"{first:.3f}s, again {again:.3f}s; launches {launches}")
    parity("lazy", qs, base, ours)
    if kinds != ["lazyph"] or launches["decode"] == 0:
        raise RuntimeError(f"the lazy path did not run: {kinds} {launches}")
    del ex
    torch.cuda.empty_cache()


def compound_queries(seg, queries, phrase):
    """Phase 7's 4 compound phrases, built from the bench's phrases: the
    bigram with the rarest member ("a b", which keeps the CPU side quick),
    c the most common phrase member, d another bigram's member."""
    df = lambda t: int(seg.term_df[seg.term_id(t)])
    members = [q.strip('"').split() for q, p in zip(queries, phrase) if p]
    pairs = sorted((m for m in members if len(m) == 2),
                   key=lambda ab: min(map(df, ab)))
    (a, b), d = pairs[0], pairs[1][0]
    c = max((t for m in members for t in m if t not in (a, b, d)), key=df)
    return [f'"{a} {b}" {c}', f'"{a} {b}" OR {c}', f'{c} NOT "{a} {b}"',
            f'("{a} {b}" {c}) OR {d}']


def phase_compound(seg, queries, phrase):
    """Compound phrases on the card against the port's CPU executor."""
    import numpy as np

    from trinity_tpu_torch import Executor
    from trinity_tpu_torch.utils import kernels

    qs = compound_queries(seg, queries, phrase)
    out, kinds = [], []
    for dev in ("cuda", "cpu"):
        ex = Executor(seg, device=dev)
        kinds.append([(g.kind, g.ctx["fcaps"] is not None)
                      for g in ex.plan_batch(qs)])
        kernels.reset_launches()
        t0 = time.perf_counter()
        out.append(ex.search_batch(qs, k=10))
        log(f"[compound] {dev}: {time.perf_counter() - t0:.3f}s, launches "
            f"{kernels.launches}")
        if dev == "cuda":
            launches = dict(kernels.launches)
    if any(k != ("phrase", True) for k in kinds[0]) or kinds[0] != kinds[1]:
        raise RuntimeError(f"compound groups took another route: {kinds}")
    if launches["decode"] == 0:
        raise RuntimeError(f"the compound path did not decode: {launches}")
    for q, g, w in zip(qs, *out):
        if [r.doc_id for r in g] != [r.doc_id for r in w]:
            raise RuntimeError(f"compound {q!r}: ids differ from the CPU")
        np.testing.assert_allclose([r.score for r in g],
                                   [r.score for r in w], rtol=RTOL, atol=0)
    log(f"[compound] {len(qs)}/{len(qs)} equal the CPU executor "
        f"(hits {[len(g) for g in out[0]]}): {qs}")
    if sum(1 for g in out[0] if g) < 3:
        raise RuntimeError("compound queries returned nothing")


COLL_UPDATES = 57_344  # generation 2: documents updating base ids
COLL_NEW = 8_192  # generation 2: new documents, ids from bench.N_DOCS up
COLL_ERASED = 8_192  # generation 3 (no documents): erased base ids


def build_generations():
    """Phase 8's newer generations and merged segment, built by the port
    and persisted under bench._cache_dir()/collection (the base segment,
    generation 1, is the bench corpus). default_rng(bench.SEED + 2) draws
    COLL_UPDATES + COLL_ERASED base ids without replacement; generation 2
    holds documents for the first COLL_UPDATES of them and for COLL_NEW
    new ids, their tokens bench's Zipf draw with bench's length range,
    indexed with bulk_index_ids, then erase(id) for each updated id (what
    update() records); generation 3 erases the other COLL_ERASED ids and
    holds no document. The merged segment is
    MergeCandidatesCollection.merge(keep_updated_ids=False) of all three;
    its seconds go to merge.json."""
    import numpy as np

    import bench
    from trinity_tpu_torch import (
        MergeCandidatesCollection,
        SegmentData,
        SegmentIndexSession,
    )

    root = os.path.join(bench._cache_dir(), "collection")
    base = SegmentData.load(os.path.join(bench._cache_dir(), "seg"))
    rng = np.random.default_rng(bench.SEED + 2)
    picked = rng.choice(bench.N_DOCS, COLL_UPDATES + COLL_ERASED,
                        replace=False)
    upd, erased = picked[:COLL_UPDATES], picked[COLL_UPDATES:]
    ids = np.sort(np.concatenate([upd, bench.N_DOCS + np.arange(COLL_NEW)]))
    zipf = 1.0 / np.arange(1, bench.VOCAB + 1) ** bench.ZIPF_S
    zipf /= zipf.sum()
    lengths = rng.integers(bench.DOC_LEN[0], bench.DOC_LEN[1], size=len(ids))
    bounds = np.zeros(len(ids) + 1, np.int64)
    np.cumsum(lengths, out=bounds[1:])
    tokens = rng.choice(bench.VOCAB, size=int(bounds[-1]), p=zipf)
    sess = SegmentIndexSession()
    sess.bulk_index_ids(ids, tokens, bounds,
                        [f"w{i}" for i in range(bench.VOCAB)])
    for d in upd:
        sess.erase(int(d))
    gen2 = sess.commit()
    sess = SegmentIndexSession()
    for d in erased:
        sess.erase(int(d))
    gen3 = sess.commit()
    mc = MergeCandidatesCollection()
    for gen, s in enumerate((base, gen2, gen3), start=1):
        mc.insert(s, gen)
    t0 = time.perf_counter()
    merged = mc.merge(keep_updated_ids=False)
    seconds = time.perf_counter() - t0
    for name, s in (("gen2", gen2), ("gen3", gen3), ("merged", merged)):
        s.persist(os.path.join(root, name))
    with open(os.path.join(root, "merge.json"), "w") as f:
        json.dump({"seconds": seconds}, f)


def load_generations():
    """(generation 2, generation 3, merged segment, merge seconds), built
    on first use (build_generations, in a subprocess) under the build
    directory."""
    import bench
    from trinity_tpu_torch import SegmentData

    root = os.path.join(bench._cache_dir(), "collection")
    if not os.path.exists(os.path.join(root, "merge.json")):
        code = ("import bench, chip_smoke; "
                f"bench.CACHE_ROOT = {bench.CACHE_ROOT!r}; "
                "chip_smoke.build_generations(); "
                "assert not chip_smoke.reference_modules(), "
                "chip_smoke.reference_modules()")
        subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
    with open(os.path.join(root, "merge.json")) as f:
        seconds = json.load(f)["seconds"]
    return (*(SegmentData.load(os.path.join(root, n))
              for n in ("gen2", "gen3", "merged")), seconds)


def same_results(what, queries, got, want, exact=False):
    """Top-k lists equal: ids exactly, scores within 2 ulp (or bit-equal
    when `exact`); raises on a difference. Returns how many lists are
    bit-equal."""
    import numpy as np

    equal = 0
    for q, g, w in zip(queries, got, want):
        if [r.doc_id for r in g] != [r.doc_id for r in w]:
            raise RuntimeError(f"{what} {q!r}: ids {[r.doc_id for r in g]} "
                               f"!= {[r.doc_id for r in w]}")
        gs, ws = [r.score for r in g], [r.score for r in w]
        equal += gs == ws
        if exact and gs != ws:
            raise RuntimeError(f"{what} {q!r}: scores {gs} != {ws}")
        np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=0, err_msg=q)
    return equal


def full_scan_rounds(ex, queries):
    """Chunk rounds search_pruned_batch would take on `ex` if no query
    resolved early: each group's windows over PRUNED_CHUNK."""
    from trinity_tpu_torch.exec import pruned

    groups, _ = pruned.plan_pruned(ex, ex._parse(queries), "bm25")
    return len(groups) * -(-ex.seg.n_windows // PRUNED_CHUNK)


def phase_collection(seg, queries, phrase):
    """Phase 8: a three-generation collection on the card (the bench
    segment, build_generations' updates and new documents, and its
    erase-only generation) against one executor over the merged segment
    searched with the collection's statistics; match_ids, doc_set, pruned
    search and residency under a budget."""
    import numpy as np
    import torch

    from trinity_tpu_torch import (
        Executor,
        IndexSourcesCollection,
        configure,
        get_config,
        get_metrics,
    )
    from trinity_tpu_torch.exec.residency import get_residency
    from trinity_tpu_torch.utils import kernels

    t0 = time.perf_counter()
    gen2, gen3, merged, merge_s = load_generations()
    log(f"[collection] generation 2: {gen2.n_docs} docs, "
        f"{len(gen2.updated_ids)} updated ids; generation 3: {gen3.n_docs} "
        f"docs, {len(gen3.updated_ids)} erased ids; merged segment "
        f"{merged.n_docs} docs; merge {merge_s:.2f}s; ready in "
        f"{time.perf_counter() - t0:.1f}s")
    bool_qs = [q for q, p in zip(queries, phrase) if not p]
    phrase_qs = [q for q, p in zip(queries, phrase) if p]
    kernels.reset_launches()
    coll = IndexSourcesCollection(device="cuda")
    for gen, s in enumerate((seg, gen2, gen3), start=1):
        coll.add_segment(s, gen)
    coll.commit()
    srcs = [s.executor() for s in coll.sources]  # newest first
    base_ex = srcs[-1]
    mex = Executor(merged, "cuda")
    stats = dict(stats=coll.aggregated_stats(), df_of=coll.doc_freq)

    # (a) the collection equals the merged segment with its statistics
    t0 = time.perf_counter()
    got = coll.search_batch(queries, k=10)
    want = mex.search_batch(queries, k=10, **stats)
    equal = same_results("collection", queries, got, want)
    newer = set(gen2.doc_map.tolist())
    fresh = sum(r.doc_id in newer for g in got for r in g)
    log(f"[collection] (a) search_batch of {len(queries)} queries equals the "
        f"merged segment's: {len(queries)}/{len(queries)} ({equal} "
        f"bit-equal; {fresh} of the hits from generation 2) in "
        f"{time.perf_counter() - t0:.2f}s")
    if sum(1 for g in got if g) < len(queries) // 2:
        raise RuntimeError("collection: most queries returned nothing")

    # (b) match_ids: the 18 phrases and the 8 rarest boolean queries
    counts = [len(mex.match_ids(q)) for q in bool_qs]
    by_count = [bool_qs[i] for i in np.argsort(counts, kind="stable")
                if counts[i] > 0]
    sizes = []
    for q in phrase_qs + by_count[:8]:
        a, b = coll.match_ids(q), mex.match_ids(q)
        if not np.array_equal(a, b):
            raise RuntimeError(f"match_ids {q!r}: {len(a)} ids on the "
                               f"collection, {len(b)} on the merged segment")
        sizes.append(len(a))
    log(f"[collection] (b) match_ids equal on {len(sizes)}/{len(sizes)} "
        f"queries (18 phrases, 8 rarest boolean): {sizes} ids")

    # (c) doc_set on the base source (its registry installed) against the
    # CPU executor (no hot-term planes: they only spare decodes)
    saved = get_config().hot_cache_bytes
    configure(hot_cache_bytes=0)
    try:
        cpu = Executor(seg, "cpu")
    finally:
        configure(hot_cache_bytes=saved)
    cpu.set_masked_local_docs(np.flatnonzero(base_ex._deleted_np))
    done = []
    for q in by_count:  # the rarest with 4 matches or more in the base
        ids = base_ex.match_ids(q)
        if len(ids) < 4:
            continue
        doc_set = ids[::2]
        g = base_ex.search(q, k=10, doc_set=doc_set)
        same_results("doc_set", [q], [g], [cpu.search(q, k=10,
                                                      doc_set=doc_set)])
        if not g or not {r.doc_id for r in g} <= set(doc_set.tolist()):
            raise RuntimeError(f"doc_set {q!r}: hits outside the set or none")
        done.append((q, len(doc_set), len(g)))
        if len(done) == 4:
            break
    if len(done) < 4:
        raise RuntimeError(f"doc_set: only {len(done)} rare queries")
    del cpu
    log(f"[collection] (c) search(doc_set=) on the card equals the CPU "
        f"executor on 4/4 rare queries (query, set size, hits): {done}")

    # (d) pruned search equals search_batch on the base executor and on
    # the collection
    bex = Executor(seg, "cuda")
    for name, run, full in (
            ("base executor", bex, full_scan_rounds(bex, bool_qs)),
            ("collection", coll, sum(full_scan_rounds(ex, bool_qs)
                                     for ex in srcs if ex.seg.n_docs))):
        dense = run.search_batch(bool_qs, k=10)
        rounds = get_metrics().snapshot().get("pruned.rounds", {}).get(
            "value", 0)
        t0 = time.perf_counter()
        pruned = run.search_pruned_batch(bool_qs, k=10,
                                         chunk_windows=PRUNED_CHUNK)
        dt = time.perf_counter() - t0
        rounds = get_metrics().snapshot()["pruned.rounds"]["value"] - rounds
        equal = same_results(f"pruned ({name})", bool_qs, pruned, dense)
        log(f"[collection] (d) {name}: search_pruned_batch equals "
            f"search_batch on {len(bool_qs)}/{len(bool_qs)} boolean queries "
            f"({equal} bit-equal) in {dt:.3f}s; pruned.rounds {rounds} "
            f"against {full} for a full scan ({PRUNED_CHUNK}-window chunks)")
    del bex, mex
    torch.cuda.empty_cache()

    # end-to-end numbers of the collection, as phase 5's
    m = slice_metrics(coll, queries, phrase)
    med = lambda k: float(np.median(m[k]))
    log(f"[collection] QPS {med('mix QPS'):.2f} (loops "
        f"{', '.join(f'{x:.2f}' for x in m['mix QPS'])}), pipelined "
        f"launch_batch/finish_batch over the sources, {len(queries)} "
        f"queries x 5 reps")
    for name in ("boolean", "phrase"):
        log(f"[collection] {name}: QPS {med(f'{name} QPS'):.2f}; search() "
            f"p50 {med(f'{name} p50 ms'):.3f} ms, p99 "
            f"{med(f'{name} p99 ms'):.3f} ms (median of 3 passes)")
    for src, ex in zip(coll.sources, srcs):
        log(f"[collection] generation {src.generation}: {src.seg.n_docs} "
            f"docs, segment arrays {ex.device_bytes} bytes, on the card now "
            f"{ex.device_bytes_held} bytes")

    # (e) a budget under the two searchable sources' segment bytes: two
    # passes evict and upload again, and the results stay (a)'s
    mgr = get_residency()
    ev0, up0 = mgr.evictions, mgr.uploads
    budget = sum(ex.device_bytes for ex in srcs if ex.seg.n_docs) - 1
    saved = get_config().hbm_budget_bytes
    configure(hbm_budget_bytes=budget)
    try:
        for ex in srcs:
            ex.evict()
        t0 = time.perf_counter()
        for _ in range(2):
            same_results("residency", queries,
                         coll.search_batch(queries, k=10), got, exact=True)
        dt = time.perf_counter() - t0
    finally:
        configure(hbm_budget_bytes=saved)
    if mgr.evictions == ev0:
        raise RuntimeError("residency: the budget evicted nothing")
    log(f"[collection] (e) budget {budget} bytes: 2 passes in {dt:.2f}s, "
        f"{mgr.evictions - ev0} evictions, {mgr.uploads - up0} uploads, "
        f"results equal (a)'s")

    # (f) every kernel of the path launched in this phase
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    log(f"[collection] (f) kernel launches in the phase: {launches}")
    if not all(launches[k] > 0 for k in ("decode", "flat", "tape",
                                          "posmask", "phrase")):
        raise RuntimeError(f"a kernel of the path never launched: {launches}")
    return coll


RICH_STREAM_CAP = 2_000  # matches of a phase-9 (a) stream compared in full
RICH_ABORT_AT = 10_000  # phase 9 (b): the callback aborts after these


def rich_stream(ex_or_coll, q, cap=RICH_STREAM_CAP):
    """exec_rich of `q`, stopped by AbortSearch after `cap` matches: the
    stream as plain values (doc id; each matched term's freq and hit
    positions), whether it was cut at `cap`, and the seconds it took."""
    from trinity_tpu_torch import AbortSearch, exec_rich

    out = []

    def on_match(md):
        out.append((md.doc_id, [(t.term, t.freq, [h.pos for h in t.hits])
                                for t in md.matched_terms]))
        if len(out) == cap:
            raise AbortSearch

    t0 = time.perf_counter()
    if hasattr(ex_or_coll, "exec_rich"):  # a collection or a mesh
        ex_or_coll.exec_rich(q, on_match)
    else:
        exec_rich(ex_or_coll, q, on_match)
    return out, len(out) == cap, time.perf_counter() - t0


def phase_rich(seg, queries, phrase, coll):
    """Phase 9: rich-match (exec_rich), intersect and threaded warmup with
    the seal on the bench deployment, one H100."""
    import numpy as np
    import torch

    from trinity_tpu_torch import AbortSearch, Executor, exec_rich, get_config
    from trinity_tpu_torch.exec.richmatch import _relax_tape, rich_pass
    from trinity_tpu_torch.exec.planning import _pad_T
    from trinity_tpu_torch.ops.postings import compute_cells
    from trinity_tpu_torch.plan.compile import compile_plan
    from trinity_tpu_torch.query.intersect import intersect
    from trinity_tpu_torch.query.parser import parse_query
    from trinity_tpu_torch.utils import kernels
    from trinity_tpu_torch.utils.seal import (
        post_seal_misses,
        seal_programs,
        unseal_programs,
    )

    t_phase = time.perf_counter()
    kernels.reset_launches()
    gpu, cpu = Executor(seg, "cuda"), Executor(seg, "cpu")
    bool_qs = [q for q, p in zip(queries, phrase) if not p]
    counts = [len(gpu.match_ids(q)) for q in bool_qs]
    order = np.argsort(counts, kind="stable")
    rare = [bool_qs[i] for i in order if counts[i] > 0][:8]

    # (a) the card's streams equal the CPU executor's, and its ids are
    # match_ids' (the first RICH_STREAM_CAP of a longer stream)
    qs = ([q for q, p in zip(queries, phrase) if p] + rare
          + compound_queries(seg, queries, phrase))
    cut = k1_rich = 0  # K1 launches of the card's exec_rich calls
    for q in qs:
        k1 = kernels.launches["decode"]
        got, capped, dt = rich_stream(gpu, q)
        k1_rich += kernels.launches["decode"] - k1
        want, _, dt_cpu = rich_stream(cpu, q)
        if got != want:
            raise RuntimeError(f"exec_rich {q!r}: the card's stream differs "
                               f"from the CPU's")
        ids = gpu.match_ids(q)
        if [d for d, _ in got] != ids[:len(got)].tolist() or (
                not capped and len(got) != len(ids)):
            raise RuntimeError(f"exec_rich {q!r}: ids differ from match_ids")
        cut += capped
        log(f"[rich] (a) {q!r}: {len(got)} matches"
            f"{' (first of ' + str(len(ids)) + ')' if capped else ''} equal "
            f"the CPU's, card {dt:.3f}s, CPU {dt_cpu:.3f}s")
    if sum(1 for q in qs if gpu.match_ids(q).size) < len(qs) // 2:
        raise RuntimeError("exec_rich: most queries matched nothing")
    log(f"[rich] (a) {len(qs)}/{len(qs)} streams equal (18 phrases, 8 rarest "
        f"boolean, 4 compound; {cut} compared over their first "
        f"{RICH_STREAM_CAP} matches)")

    # (b) the boolean query with the most matches, aborted at RICH_ABORT_AT
    heavy = bool_qs[int(order[-1])]
    plan = compile_plan(parse_query(heavy).root)
    T = _pad_T(plan.n_slots)
    cs, cn = compute_cells(seg, [seg.term_id(t) for t in plan.term_texts])
    cs, cn = (np.pad(a, ((0, 0), (0, T - plan.n_slots))) for a in (cs, cn))
    relaxed = _relax_tape(plan.tape)
    cap = get_config().rich_candidate_cap
    rich_pass(gpu, relaxed, cs, cn, cap)  # warm
    dev_ms = []
    for _ in range(5):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        C, local, _, _ = rich_pass(gpu, relaxed, cs, cn, cap)
        e.record()
        e.synchronize()
        dev_ms.append(s.elapsed_time(e))
    delivered = []

    def on_match(md):
        if len(delivered) == RICH_ABORT_AT:
            raise AbortSearch
        delivered.append(md.doc_id)

    t0 = time.perf_counter()
    k1 = kernels.launches["decode"]
    n = exec_rich(gpu, heavy, on_match)
    k1_rich += kernels.launches["decode"] - k1
    wall = time.perf_counter() - t0
    ids = gpu.match_ids(heavy)
    if n != RICH_ABORT_AT or delivered != ids[:RICH_ABORT_AT].tolist():
        raise RuntimeError(f"AbortSearch: {n} delivered, ids "
                           f"{'equal' if delivered == ids[:n].tolist() else 'differ'}")
    dms = float(np.median(dev_ms))
    log(f"[rich] (b) {heavy!r} ({counts[int(order[-1])]} matches, "
        f"{len(local)} candidates, T={T}): AbortSearch after {n} = the first "
        f"{n} of match_ids; device pass {dms:.4f} ms (CUDA events, median of "
        f"5), candidates C = {C}; exec_rich {wall:.3f}s, host "
        f"materialization {(wall * 1e3 - dms) / (n / 1000):.3f} ms per 1,000 "
        f"matches")

    # (c) the collection: per source ascending, the union is match_ids
    srcs = [src.executor() for src in coll.sources if not src.index_empty()]
    for q in rare:
        k1 = kernels.launches["decode"]
        got, capped, _ = rich_stream(coll, q, cap=None)
        k1_rich += kernels.launches["decode"] - k1
        per = [ex.match_ids(q) for ex in srcs]
        parts, at = [], 0
        for ids in per:
            parts.append([d for d, _ in got[at:at + len(ids)]])
            at += len(ids)
        if at != len(got) or any(p != ids.tolist()
                                 for p, ids in zip(parts, per)):
            raise RuntimeError(f"collection exec_rich {q!r}: a source's "
                               f"stream differs from its match_ids")
        union = np.unique([d for d, _ in got]).astype(np.uint32)
        if not np.array_equal(union, coll.match_ids(q)):
            raise RuntimeError(f"collection exec_rich {q!r}: the union "
                               f"differs from coll.match_ids")
    log(f"[rich] (c) collection exec_rich on the 8 rarest boolean queries: "
        f"each source's stream ascending and equal to its match_ids, the "
        f"union equal to the collection's match_ids (8/8)")

    # (d) intersect on the card equals the CPU executor's
    k1_intersect = 0
    for toks in (query_terms(longest_boolean(queries)),
                 wide_intersect_terms(seg, queries)):
        times = []
        for ex in (gpu, cpu):
            k1 = kernels.launches["decode"]
            t0 = time.perf_counter()
            res = intersect(ex, toks)
            times.append(time.perf_counter() - t0)
            k1_intersect += kernels.launches["decode"] - k1
            if ex is gpu:
                got = res
        if got != res:
            raise RuntimeError(f"intersect of {len(toks)} tokens: the card's "
                               f"list differs from the CPU's")
        log(f"[rich] (d) intersect of {len(toks)} tokens: {len(got)} "
            f"(mask, count) pairs equal the CPU's; card {times[0]:.3f}s, "
            f"CPU {times[1]:.3f}s")
    del cpu
    torch.cuda.synchronize()
    launches = dict(kernels.launches)

    # (e) threaded warmup on a fresh executor, then the strict seal
    builds = {}

    def counting(ex, name):
        build = getattr(ex, name)

        def counted():
            builds[name] = builds.get(name, 0) + 1
            return build()
        setattr(ex, name, counted)

    w1 = Executor(seg, "cuda").warmup(queries, k=10, threads=1)
    torch.cuda.empty_cache()
    ex = Executor(seg, "cuda")
    for name in ("_build_tf_planes", "_build_pos_planes"):
        counting(ex, name)
    w8 = ex.warmup(queries, k=10, threads=8)
    if builds != {"_build_tf_planes": 1, "_build_pos_planes": 1}:
        raise RuntimeError(f"warmup(threads=8) built the caches {builds}")
    before = post_seal_misses()
    seal_programs(strict=True)
    try:
        qps(ex, queries)
        for q in queries:
            ex.search(q, k=10)
        torch.cuda.synchronize()
    finally:
        unseal_programs()
    misses = post_seal_misses() - before
    if misses:
        raise RuntimeError(f"{misses} post-seal misses")
    log(f"[rich] (e) warmup of {len(queries)} queries: threads=8 "
        f"{w8['seconds']:.3f}s ({w8['programs']} variants first recorded), "
        f"threads=1 {w1['seconds']:.3f}s ({w1['programs']}); each hot cache "
        f"built once under 8 threads; sealed strict, the mix pipelined and "
        f"blocking: {misses} post-seal misses")

    # (f) K1 launched in the phase
    log(f"[rich] (f) K1 launches: {k1_rich} by exec_rich's device passes "
        f"in (a)-(c) (one a call and source), {k1_intersect} by intersect in "
        f"(d); all kernels in (a)-(d), match_ids included: {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    if not (k1_rich and k1_intersect):
        raise RuntimeError(f"the decode kernel never launched: {launches}")


# Phase 10's deployment: tools/measure_percolator.py's (BASELINE config #4)
PERC_N_QUERIES = 5000
PERC_VOCAB = 3000
PERC_DOC_BATCH = 2048
PERC_DOC_LEN = (40, 81)
PERC_N_BATCHES = 8
PERC_ZIPF_S = 1.07
PERC_SCALE = (50_000, 512)  # the tool's scale_50k: queries, batch docs


def perc_queries(rng, n_queries=PERC_N_QUERIES):
    """tools/measure_percolator.py:build_queries (the same draws), as
    texts: 40% AND of 2-3 terms, 25% OR of 2-3, 15% NOT, 10% 2-of-4, 10%
    phrase bigrams and trigrams, Zipf-drawn from PERC_VOCAB terms."""
    import numpy as np

    zipf = 1.0 / np.arange(1, PERC_VOCAB + 1) ** PERC_ZIPF_S
    zipf /= zipf.sum()
    pick = lambda: int(rng.choice(PERC_VOCAB, p=zipf))

    def distinct(n):
        out = []
        while len(out) < n:
            t = pick()
            if t not in out:
                out.append(t)
        return out

    texts = []
    for i in range(n_queries):
        kind = i % 20
        if kind < 8:
            ts = distinct(2 if kind < 5 else 3)
            texts.append(" ".join(f"p{t}" for t in ts))
        elif kind < 13:
            ts = distinct(2 if kind < 11 else 3)
            texts.append(" OR ".join(f"p{t}" for t in ts))
        elif kind < 16:
            a, b = distinct(2)
            texts.append(f"p{a} NOT p{b}")
        elif kind < 18:
            ts = distinct(4)
            texts.append("[" + ",".join(f"p{t}" for t in ts) + "]/2")
        else:
            ts = distinct(2 if kind == 18 else 3)
            texts.append('"' + " ".join(f"p{t}" for t in ts) + '"')
    return texts


def perc_docs(rng, n_docs):
    """tools/measure_percolator.py:gen_docs (the same draws)."""
    import numpy as np

    zipf = 1.0 / np.arange(1, PERC_VOCAB + 1) ** PERC_ZIPF_S
    zipf /= zipf.sum()
    docs = []
    for _ in range(n_docs):
        ln = int(rng.integers(*PERC_DOC_LEN))
        docs.append([f"p{int(t)}" for t in rng.choice(PERC_VOCAB, ln, p=zipf)])
    return docs


def host_eval(ops, incidence, ph_inc):
    """tools/measure_percolator.py:host_eval: a per-query numpy postfix
    loop over the documents (the host denominator and the check)."""
    import numpy as np

    n_docs = incidence.shape[0]
    n_q = ops.shape[0]
    out = np.zeros((n_docs, n_q), bool)
    for qi in range(n_q):
        stack = []
        for op, arg in ops[qi]:
            if op == 0:
                continue
            elif op == 1:
                stack.append(np.zeros(n_docs, np.int32))
            elif op == 2:
                stack.append(np.ones(n_docs, np.int32))
            elif op == 3:
                stack.append(incidence[:, arg].astype(np.int32))
            elif op == 4:
                stack.append(ph_inc[:, arg].astype(np.int32))
            elif op == 5:
                b, a = stack.pop(), stack.pop()
                stack.append(((a > 0) & (b > 0)).astype(np.int32))
            elif op == 6:
                b, a = stack.pop(), stack.pop()
                stack.append(((a > 0) | (b > 0)).astype(np.int32))
            elif op == 7:
                b, a = stack.pop(), stack.pop()
                stack.append(((a > 0) & (b == 0)).astype(np.int32))
            elif op == 8:
                stack.append((stack.pop() == 0).astype(np.int32))
            elif op == 9:
                stack.append(np.ones_like(stack.pop()))
            elif op == 10:
                b, a = stack.pop(), stack.pop()
                stack.append(a + b)
            elif op == 11:
                stack.append((stack.pop() >= arg).astype(np.int32))
        out[:, qi] = stack[0] > 0
    return out


def percolator_config(n_queries, doc_batch):
    """One deployment of phase 10 on the card: register, then
    PERC_N_BATCHES batches of `doc_batch` documents; checks and numbers
    (returned as a dict)."""
    import numpy as np
    import torch

    from trinity_tpu_torch import Percolator
    from trinity_tpu_torch.percolator import finish_eval, launch_eval

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rng = np.random.default_rng(77)
    perc = Percolator(device="cuda")
    t0 = time.perf_counter()
    for q in perc_queries(rng, n_queries):
        perc.register(q)
    ops, uniq, staged = perc._epoch()  # packed and staged: one epoch
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t0
    batches = [perc_docs(rng, doc_batch) for _ in range(PERC_N_BATCHES)]

    # the host denominator on every batch: incidence + numpy postfix, which
    # is also what the card's matrices are held to
    host_s, inc_ms, want = [], [], []
    for docs in batches:
        t1 = time.perf_counter()
        inc, ph = perc.build_incidence(docs, uniq)
        inc_ms.append((time.perf_counter() - t1) * 1e3)
        want.append(host_eval(ops, inc, ph))
        host_s.append(time.perf_counter() - t1)
    # the device evaluation alone (upload included), by CUDA events
    dev_ms = []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for docs in batches:
        inc, ph = perc.build_incidence(docs, uniq)
        torch.cuda.synchronize()
        ev[0].record()
        out = launch_eval(staged, inc, ph)
        ev[1].record()
        got = finish_eval(out)
        dev_ms.append(ev[0].elapsed_time(ev[1]))
    np.testing.assert_array_equal(got, want[-1])
    # sequential match_batch: each batch's latency, each against the host
    lat = []
    for docs, w in zip(batches, want):
        t1 = time.perf_counter()
        got = perc.match_batch(docs)
        lat.append((time.perf_counter() - t1) * 1e3)
        np.testing.assert_array_equal(got, w)
    # the stream (host incidence of batch k+1 beside batch k's evaluation)
    t1 = time.perf_counter()
    streamed = list(perc.match_stream(batches))
    wall = time.perf_counter() - t1
    for g, w in zip(streamed, want):
        np.testing.assert_array_equal(g, w)
    peak = torch.cuda.max_memory_allocated() - base
    # the port's CPU run on batch 0
    cpu = Percolator(device="cpu")
    for q in perc_queries(np.random.default_rng(77), n_queries):
        cpu.register(q)
    t1 = time.perf_counter()
    np.testing.assert_array_equal(cpu.match_batch(batches[0]), want[0])
    cpu_s = time.perf_counter() - t1
    return {
        "queries": perc.n_queries, "doc_batch": doc_batch,
        "unique phrases": len(uniq), "terms": len(perc._vocab),
        "program slots": ops.shape[1], "stack depth": staged["depth"],
        "docs/s": PERC_N_BATCHES * doc_batch / wall,
        "batch p50 ms": float(np.percentile(lat, 50)),
        "batch p99 ms": float(np.percentile(lat, 99)),
        "register s": reg_s,
        "device eval ms (median)": float(np.median(dev_ms)),
        "host incidence ms (median)": float(np.median(inc_ms)),
        "host docs/s": doc_batch / float(np.median(host_s)),
        "cpu port batch 0 s": cpu_s,
        "peak device bytes": int(peak),
        "matches (batch 0)": int(want[0].sum()),
    }


def phase_percolator():
    """Phase 10: the percolator on the card (BASELINE config #4), at
    tools/measure_percolator.py's two deployments."""
    for n_q, batch in ((PERC_N_QUERIES, PERC_DOC_BATCH), PERC_SCALE):
        t0 = time.perf_counter()
        r = percolator_config(n_q, batch)
        log(f"[percolator] {n_q} queries x {PERC_N_BATCHES} batches of "
            f"{batch} docs: the card's matrices equal the host postfix eval "
            f"on {PERC_N_BATCHES}/{PERC_N_BATCHES} batches, the port's CPU "
            f"run on batch 0, and match_stream equals match_batch; "
            f"{time.perf_counter() - t0:.1f}s")
        log("[percolator]   " + json.dumps(r))
        if not r["matches (batch 0)"]:
            raise RuntimeError("percolator: nothing matched")


def split_shards(seg, n_shards=4):
    """Phase 11's shards: the bench segment split by split_segment."""
    from trinity_tpu_torch.parallel import split_segment

    t0 = time.perf_counter()
    shards = split_segment(seg, n_shards)
    log(f"[mesh] split_segment into {n_shards} shards "
        f"{time.perf_counter() - t0:.2f}s: "
        f"{[(s.n_docs, s.n_windows) for s in shards]} (docs, windows)")
    return shards


def blocking_split(run, queries):
    """Host ms of one blocking batch on `run` (an executor or a mesh):
    (launch_batch, then the wait for the card, then finish_batch)."""
    import torch

    t0 = time.perf_counter()
    h = run.launch_batch(queries, k=10)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    run.finish_batch(h)
    t3 = time.perf_counter()
    return [(t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3]


@contextlib.contextmanager
def shard_tally(mex):
    """Per shard of `mex`, the kernel launches its executor makes inside
    the mesh's launch_batch / finish_batch, which call the shards one after
    another on the caller's thread: each shard executor's launch_groups
    and finish_rows add the change of the counts across the call to that
    shard's tally while the block runs."""
    from trinity_tpu_torch.utils import kernels

    tally = [dict.fromkeys(kernels.launches, 0) for _ in mex.executors]

    def counted(fn, t):
        def run(*args, **kwargs):
            before = dict(kernels.launches)
            try:
                return fn(*args, **kwargs)
            finally:
                for k in t:
                    t[k] += kernels.launches[k] - before[k]
        return run

    for ex, t in zip(mex.executors, tally):
        ex.launch_groups = counted(ex.launch_groups, t)
        ex.finish_rows = counted(ex.finish_rows, t)
    try:
        yield tally
    finally:
        for ex in mex.executors:
            del ex.launch_groups, ex.finish_rows


def phase_mesh(seg, shards, queries, phrase, base_topk, single, m5, coll):
    """Phase 11: the mesh on the card (BASELINE config #5): four shards
    of the bench segment on cuda:0 against phase 5's single executor
    (`single`: its 120 results, `m5`: its end-to-end numbers), under a
    mask, pruned, match_ids / exec_rich, phase 8's generations sharded
    against phase 8's collection (`coll`), warmup and the strict seal, and
    each shard's kernels. Returns the kernel launches of the mesh's first
    batch."""
    import numpy as np
    import torch

    from trinity_tpu_torch import Executor
    from trinity_tpu_torch.parallel import MeshExecutor, MeshSourcesCollection
    from trinity_tpu_torch.utils import kernels
    from trinity_tpu_torch.utils.seal import (
        post_seal_misses,
        seal_programs,
        unseal_programs,
    )

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    mex = MeshExecutor(shards)  # every visible card: four shards on the one

    # (a) and (g): the mesh's first batch (each shard builds its hot caches
    # in it), with the counts zeroed just before it and read just after:
    # parity with the baseline engine, bit-equal to phase 5's single
    # executor, and K1-K4 launched by every shard's executor
    with shard_tally(mex) as per_shard:
        kernels.reset_launches()
        h = mex.launch_batch(queries, k=10)
        got = mex.finish_batch(h)
        launches = dict(kernels.launches)
    parity("mesh", queries, base_topk, got)
    same_results("mesh (a)", queries, got, single, exact=True)
    log(f"[mesh] (a) launch_batch/finish_batch on {len(shards)} shards on "
        f"{sorted({str(d) for d in mex.devices})}: {len(queries)}/"
        f"{len(queries)} ids and scores bit-equal to phase 5's executor")
    log(f"[mesh] (g) kernel launches of the mesh's batch {launches}; by "
        f"shard {per_shard}")
    by_shard = {k: sum(t[k] for t in per_shard) for k in launches}
    if by_shard != launches:
        raise RuntimeError(f"mesh (g): the shards' tallies {by_shard} are "
                           f"not the batch's launches {launches}")
    if not all(n > 0 for t in per_shard for n in t.values()):
        raise RuntimeError(f"mesh (g): a shard left a kernel unlaunched: "
                           f"{per_shard}")
    w = mex.warmup(queries, k=10)
    log(f"[mesh] warmup {w['seconds']:.2f}s")

    # (b) every 7th global docid masked, against a single executor
    ex = Executor(seg, "cuda")
    masked = np.arange(0, seg.n_docs, 7)
    mex.set_masked_local_docs(masked)
    ex.set_masked_local_docs(masked)
    got_m = mex.search_batch(queries, k=10)
    same_results("mesh (b)", queries, got_m, ex.search_batch(queries, k=10),
                 exact=True)
    dead = set(seg.doc_map[masked].tolist())
    if dead & {r.doc_id for g in got_m for r in g}:
        raise RuntimeError("mesh (b): a masked document came back")
    mex.set_masked_local_docs(None)
    ex.set_masked_local_docs(None)
    log(f"[mesh] (b) {len(masked)} masked docids (every 7th): "
        f"{len(queries)}/{len(queries)} bit-equal to the single executor "
        f"under the same mask")

    # (c) pruned equals dense on the boolean queries
    bool_qs = [q for q, p in zip(queries, phrase) if not p]
    phrase_qs = [q for q, p in zip(queries, phrase) if p]
    t0 = time.perf_counter()
    pruned = mex.search_pruned_batch(bool_qs, k=10,
                                     chunk_windows=PRUNED_CHUNK)
    dt = time.perf_counter() - t0
    same_results("mesh (c)", bool_qs, pruned,
                 [g for g, p in zip(got, phrase) if not p], exact=True)
    log(f"[mesh] (c) search_pruned_batch equals search_batch on "
        f"{len(bool_qs)}/{len(bool_qs)} boolean queries in {dt:.3f}s")

    # (d) match_ids and exec_rich: the 18 phrases, the 8 rarest boolean
    counts = [len(ex.match_ids(q)) for q in bool_qs]
    rare = [bool_qs[i] for i in np.argsort(counts, kind="stable")
            if counts[i] > 0][:8]
    sizes, cut = [], 0
    t0 = time.perf_counter()
    for q in phrase_qs + rare:
        a, b = mex.match_ids(q), ex.match_ids(q)
        if not np.array_equal(a, b):
            raise RuntimeError(f"mesh (d) match_ids {q!r}: {len(a)} != "
                               f"{len(b)}")
        (sa, ca, _), (sb, cb, _) = rich_stream(mex, q), rich_stream(ex, q)
        if sa != sb or ca != cb:
            raise RuntimeError(f"mesh (d) exec_rich {q!r}: streams differ")
        sizes.append(len(a))
        cut += ca
    log(f"[mesh] (d) match_ids and exec_rich streams equal the single "
        f"executor's on {len(sizes)}/{len(sizes)} queries ({cut} streams "
        f"compared over their first {RICH_STREAM_CAP}): {sizes} ids; "
        f"{time.perf_counter() - t0:.2f}s")

    # where a blocking batch's time goes, the mesh beside one executor
    for name, run in (("mesh", mex), ("single executor", ex)):
        split = np.median([blocking_split(run, queries) for _ in range(5)],
                          axis=0)
        log(f"[mesh] one blocking batch of {len(queries)} on the {name}: "
            f"launch {split[0]:.3f} ms, wait for the card {split[1]:.3f} "
            f"ms, finish {split[2]:.3f} ms (medians of 5)")
    del ex
    torch.cuda.empty_cache()

    # end-to-end numbers beside phase 5's
    m = slice_metrics(mex, queries, phrase)
    med = lambda d, k: float(np.median(d[k]))
    log(f"[mesh] QPS {med(m, 'mix QPS'):.2f} (loops "
        f"{', '.join(f'{x:.2f}' for x in m['mix QPS'])}) against phase 5's "
        f"{med(m5, 'mix QPS'):.2f} (ratio "
        f"{med(m, 'mix QPS') / med(m5, 'mix QPS'):.3f}), {len(queries)} "
        f"queries x 5 reps")
    for name in ("boolean", "phrase"):
        log(f"[mesh] {name}: QPS {med(m, f'{name} QPS'):.2f} (phase 5 "
            f"{med(m5, f'{name} QPS'):.2f}); search() p50 "
            f"{med(m, f'{name} p50 ms'):.3f} ms (phase 5 "
            f"{med(m5, f'{name} p50 ms'):.3f}), p99 "
            f"{med(m, f'{name} p99 ms'):.3f} ms (phase 5 "
            f"{med(m5, f'{name} p99 ms'):.3f})")

    # (f) the strict seal after (a)-(d)'s warmup: the mix misses nothing
    before = post_seal_misses()
    seal_programs(strict=True)
    try:
        qps(mex, queries)
        for q in queries:
            mex.search(q, k=10)
        torch.cuda.synchronize()
    finally:
        unseal_programs()
    misses = post_seal_misses() - before
    if misses:
        raise RuntimeError(f"mesh (f): {misses} post-seal misses")
    log(f"[mesh] (f) warmup then seal_programs(strict=True): the mix, "
        f"pipelined and blocking, {misses} post-seal misses")
    del mex
    torch.cuda.empty_cache()

    # (e) phase 8's generations, each split into four shards
    gen2, gen3, _, _ = load_generations()
    t0 = time.perf_counter()
    meshc = MeshSourcesCollection(n_shards=len(shards))
    for gen, s in enumerate((seg, gen2, gen3), start=1):
        meshc.add_segment(s, gen)
    meshc.commit()
    built = time.perf_counter() - t0
    empty = [s.n_docs for s in meshc.sources[0].executor().shards]
    if meshc.sources[0].generation != 3 or any(empty):
        raise RuntimeError(f"mesh (e): the erase-only generation's shards "
                           f"hold {empty} docs")
    want = coll.search_batch(queries, k=10)
    got_c = meshc.search_batch(queries, k=10)
    equal = same_results("mesh (e)", queries, got_c, want)
    log(f"[mesh] (e) MeshSourcesCollection over phase 8's 3 generations "
        f"(split and built in {built:.2f}s; generation 3's shards {empty} "
        f"docs) equals phase 8's IndexSourcesCollection: ids on "
        f"{len(queries)}/{len(queries)}, scores within 2 ulp ({equal} "
        f"bit-equal)")
    del meshc
    torch.cuda.empty_cache()
    log(f"[mesh] phase {time.perf_counter() - t_phase:.1f}s")
    return launches


# device functions the executor calls, timed one by one by --profile
PROFILED = ("materialize_freq_tiles", "fused_flat_score_tiles",
            "fused_score_tiles", "materialize_posmask_tiles",
            "phrase_score_tiles", "exact_window_topk", "topk_lowest_index",
            "bound_select_candidates", "compact_mask", "verify_phrases_device")


def profile_groups(ex, queries, tag):
    """Each group of one batch, run alone 5 times: median host time of its
    launch, device time of the whole group and of each PROFILED function
    it calls (CUDA events, summed over its calls)."""
    import numpy as np
    import torch

    from trinity_tpu_torch.exec import executor as exmod

    spans = []

    def timed(name, fn):
        def run(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **kw)
            e.record()
            spans.append((name, s, e))
            return out
        return run

    saved = {n: getattr(exmod, n) for n in PROFILED}
    for n, fn in saved.items():
        setattr(exmod, n, timed(n, fn))
    try:
        for g in ex.plan_batch(queries):
            reps = []
            for _ in range(5):
                torch.cuda.synchronize()
                spans.clear()
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0 = time.perf_counter()
                s.record()
                ex.run_group(g, 10, "bm25")
                e.record()
                host = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
                fns = {}
                for n, a, b in spans:
                    fns[n] = fns.get(n, 0.0) + a.elapsed_time(b)
                reps.append((s.elapsed_time(e), host, fns))
            med = lambda xs: float(np.median(xs))
            ctx = {c: g.ctx[c] for c in ("C", "C2", "fcaps") if c in g.ctx}
            log(f"[profile] {tag} {g.kind} B={g.B} T={g.T} "
                f"cells={g.arrays['cs'].shape[1]} {ctx}: device "
                f"{med([r[0] for r in reps]):.4f} ms, host launch "
                f"{med([r[1] for r in reps]):.4f} ms; " + ", ".join(
                    f"{n} {med([r[2].get(n, 0.0) for r in reps]):.4f}"
                    for n in reps[0][2]))
    finally:
        for n, fn in saved.items():
            setattr(exmod, n, fn)


def phase_profile(seg, queries, phrase):
    """Where the time goes (--profile): the host split of one blocking
    batch, the device busy share of 10 pipelined batches (torch.profiler
    kernel time over wall time) with its top kernels, and each group's
    device time by function, for the mix, its boolean and phrase parts,
    and the phrases on the lazy path."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from trinity_tpu_torch import Executor, configure, get_config

    parts = {
        "mix": queries,
        "boolean": [q for q, p in zip(queries, phrase) if not p],
        "phrase": [q for q, p in zip(queries, phrase) if p],
    }
    ex = Executor(seg, device="cuda")
    ex.warmup(queries, k=10)
    for name, qs in parts.items():
        split = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            groups = ex.plan_batch(qs)
            t1 = time.perf_counter()
            outs = [ex.run_group(g, 10, "bm25") for g in groups]
            t2 = time.perf_counter()
            ex.finish_batch((groups, outs, len(qs), 10, "bm25", t2, None))
            split.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
        plan, launch, finish = np.median(np.array(split) * 1e3, axis=0)
        log(f"[profile] {name} ({len(qs)} queries), one blocking batch: "
            f"plan {plan:.4f} ms, launch {launch:.4f} ms, finish "
            f"{finish:.4f} ms (medians of 5)")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = 10 * len(qs) / qps(ex, qs, reps=10) * 1e3
        dev = lambda ev: getattr(ev, "self_device_time_total",
                                 getattr(ev, "self_cuda_time_total", 0))
        evs = sorted(prof.key_averages(), key=dev, reverse=True)
        busy = sum(dev(ev) for ev in evs) / 1e3
        log(f"[profile] {name}: 10 pipelined batches, wall {wall:.3f} ms, "
            f"device busy {busy:.3f} ms, busy share {busy / wall:.4f}")
        for ev in evs[:5]:
            log(f"[profile]   {dev(ev) / 1e3:.3f} ms in {ev.count}: "
                f"{ev.key[:90]}")
    profile_groups(ex, queries, "mix")
    del ex
    torch.cuda.empty_cache()
    saved = get_config().use_posmask
    configure(use_posmask=False)
    try:
        ex = Executor(seg, device="cuda")
        ex.warmup(parts["phrase"], k=10)
        profile_groups(ex, parts["phrase"], "lazy")
    finally:
        configure(use_posmask=saved)


def main():
    args = sys.argv[1:]
    if not (args in ([], ["--profile"])
            or (len(args) == 2 and args[0] == "--turns")):
        raise SystemExit(
            "usage: python3 chip_smoke.py [--profile | --turns PARENT_TREE]")
    phase_device()
    import torch

    phase_build()
    if args[:1] == ["--turns"]:
        phase_turns(args[1])
        log(nvidia_smi())
        return
    seg, queries, base_topk, phrase = phase_corpus()
    if args == ["--profile"]:
        phase_profile(seg, queries, phrase)
        log(nvidia_smi())
        return
    shards = split_shards(seg)
    rows = phase_kernels(seg, queries, shards)
    launches, single, m5 = phase_slice(seg, queries, base_topk, phrase)
    phase_lazy(seg, queries, base_topk, phrase)
    phase_compound(seg, queries, phrase)
    coll = phase_collection(seg, queries, phrase)
    phase_rich(seg, queries, phrase, coll)
    phase_percolator()
    mesh_launches = phase_mesh(seg, shards, queries, phrase, base_topk, single,
                               m5, coll)
    del coll
    loaded = reference_modules()
    log(f"[imports] modules of the JAX package loaded in this run: {loaded}")
    if loaded:
        raise RuntimeError(f"the port loaded the JAX package: {loaded}")
    out = [dict(rows[k], route="cuda", launches=launches[k],
                mesh_launches=mesh_launches[k])
           for k in ("decode", "flat", "tape", "posmask", "phrase")]
    log(json.dumps({"kernels": out}))
    log(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
