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
   4, 8) and on one query alone (search()'s B = 1), K3 on the OR-of-AND
   group, K4 on
   the first 8-term chunk of the posmask hot cache and on the bigram and
   trigram groups' uncached cells, all over every window;
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
   merge's seconds and each source's device bytes.

The last lines: the check that no trinity_tpu module was loaded, one JSON
object {"kernels": [...]}, the nvidia-smi line (name, power limit), and
{"ok": true, "device": {...}}.

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

    from trinity_tpu_torch.ops import fusedscore as fs
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
        a = {n: put(v) for n, v in g.arrays.items()}
        head = (ex.bmeta, ex.planes, a["cs"], a["cn"], a["weights"])
        what = (f"B={g.B} with {len(g.members)} queries, T={g.T}, "
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
        cases.append((key, what, call, ref, nb,
                      lambda tp=g.tape: program_size(tp)))
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
    return cases


PRUNED_CHUNK = 16  # search_pruned_batch's default chunk_windows


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
}


def phase_kernels(seg, queries):
    """Each kernel against its plain version at the main path's shapes:
    integer tiles bit-equal, scores within 2 ulp; median times, and the
    bound from the bytes (and f32 operations) the call must move."""
    import torch

    from trinity_tpu_torch import Executor
    from trinity_tpu_torch.utils import kernels

    ex = Executor(seg, device="cuda")
    rows = {}
    for key, what, call, ref, nbytes, detail in kernel_cases(ex, queries):
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
    del ex
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
                                          "posmask")):
        raise RuntimeError(f"a kernel of the path never launched: {launches}")
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    log(f"[slice] device bytes {ex.device_bytes_held} (segment "
        f"{nb(ex.bmeta, ex.planes)}, positions {nb(ex.hit_pw, ex.hit_off)}, "
        f"hot planes {nb(ex.tf_planes)} for {len(ex._hot)} terms, posmask "
        f"cache {nb(ex.pos_planes)} for {len(ex._pos_hot)} terms, PW "
        f"{ex._pw_words}); peak allocated {torch.cuda.max_memory_allocated()}")
    return launches


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


def phase_compound(seg, queries, phrase):
    """Compound phrases on the card against the port's CPU executor."""
    import numpy as np

    from trinity_tpu_torch import Executor
    from trinity_tpu_torch.utils import kernels

    df = lambda t: int(seg.term_df[seg.term_id(t)])
    members = [q.strip('"').split() for q, p in zip(queries, phrase) if p]
    # the bigram with the rarest member keeps the CPU side quick; c, the
    # most common phrase member, meets it; d is another bigram's member
    pairs = sorted((m for m in members if len(m) == 2),
                   key=lambda ab: min(map(df, ab)))
    (a, b), d = pairs[0], pairs[1][0]
    c = max((t for m in members for t in m if t not in (a, b, d)), key=df)
    qs = [f'"{a} {b}" {c}', f'"{a} {b}" OR {c}', f'{c} NOT "{a} {b}"',
          f'("{a} {b}" {c}) OR {d}']
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
                                          "posmask")):
        raise RuntimeError(f"a kernel of the path never launched: {launches}")


# device functions the executor calls, timed one by one by --profile
PROFILED = ("materialize_freq_tiles", "fused_flat_score_tiles",
            "fused_score_tiles", "materialize_posmask_tiles",
            "phrase_freq_from_masks", "exact_window_topk", "topk_lowest_index",
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
            ex.finish_batch((groups, outs, len(qs), 10, "bm25", t2))
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
    rows = phase_kernels(seg, queries)
    launches = phase_slice(seg, queries, base_topk, phrase)
    phase_lazy(seg, queries, base_topk, phrase)
    phase_compound(seg, queries, phrase)
    phase_collection(seg, queries, phrase)
    loaded = reference_modules()
    log(f"[imports] modules of the JAX package loaded in this run: {loaded}")
    if loaded:
        raise RuntimeError(f"the port loaded the JAX package: {loaded}")
    out = [dict(rows[k], route="cuda", launches=launches[k])
           for k in ("decode", "flat", "tape", "posmask")]
    log(json.dumps({"kernels": out}))
    log(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
