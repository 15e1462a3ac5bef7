"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``; every test skips when torch sees no CUDA card (decided in
the fixture, not at import). On a machine with a card, run them with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports jax, which the port's GPU
machine need not have; this file imports only the port, which it steers
with the port's own ``configure``.)

Tolerances: freq, offset and position-word tiles, top-k ids, rich-match
streams and intersect lists must be
bit-equal;
scores and sub-block maxima within 2 ulp (rtol=2.4e-7, atol=0), the
repo's engine-vs-oracle bound — the kernels keep the plain version's f32
operation order, so in practice they agree exactly.
"""

import numpy as np
import pytest
import torch

from trinity_tpu_torch import (
    Executor,
    SegmentIndexSession,
    configure,
    get_config,
)
from trinity_tpu_torch.ops.fusedscore import (
    encode_tape,
    fused_flat_score_tiles,
    fused_flat_score_tiles_ref,
    fused_score_tiles,
    fused_score_tiles_ref,
    tape_used_slots,
)
from trinity_tpu_torch.ops.posmask import (
    materialize_posmask_tiles,
    materialize_posmask_tiles_ref,
    phrase_score_tiles,
    phrase_score_tiles_ref,
)
from trinity_tpu_torch.ops.postings import (
    compute_cells,
    materialize_freq_tiles,
    materialize_freq_tiles_ref,
)
from trinity_tpu_torch.utils import kernels
from torch_blocks import wide_blocks
from torch_words import phrase_group

pytestmark = pytest.mark.cuda

RTOL = 2.4e-7  # 2 ulp


def make_segment(seed=7, n_docs=40_000, vocab=400):
    """Zipf corpus over 3 windows, plus docs with freqs above 255 (wide
    freq fields) and a sparse term (wide doc-delta fields)."""
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, vocab + 1) ** 1.1
    zipf /= zipf.sum()
    docs = [list(rng.choice(vocab, size=int(rng.integers(3, 12)), p=zipf))
            for _ in range(n_docs)]
    for d in rng.choice(n_docs, size=40, replace=False):
        docs[d] += [vocab] * int(rng.integers(200, 3000))
    for d in range(0, n_docs, 7919):
        docs[d].append(vocab + 1)
    bounds = np.zeros(n_docs + 1, np.int64)
    np.cumsum([len(d) for d in docs], out=bounds[1:])
    sess = SegmentIndexSession()
    sess.bulk_index_ids(
        np.arange(n_docs) * 3 + 1, np.concatenate(docs), bounds,
        [f"t{i}" for i in range(vocab + 2)],
    )
    return sess.commit()


QUERIES = [
    "t0 t1", "t2 t400", "t3 OR t40 OR t200", "t2 NOT t0", "t401 t0",
    "[t5, t9, t31, t77]/2", "t1 <t7>", "t0 NOT (t1 OR t2)",
    "(t0 t9) OR (t3 t50)", "(t400 t1) OR (t401 t2)",
    " OR ".join(f"t{i}" for i in range(20, 31)),
]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def seg(dev):
    return make_segment()


@pytest.fixture()
def hot_cfg():
    cfg = get_config()
    saved = (cfg.hot_cache_bytes, cfg.hot_cache_min_df)
    configure(hot_cache_bytes=64 << 20, hot_cache_min_df=2000)
    yield
    configure(hot_cache_bytes=saved[0], hot_cache_min_df=saved[1])


def assert_scores(a, b):
    assert torch.equal(torch.isinf(a), torch.isinf(b))
    fin = torch.isfinite(b)
    torch.testing.assert_close(a[fin], b[fin], rtol=RTOL, atol=0)


@pytest.mark.parametrize("with_offsets", [False, True])
def test_decode_kernel_bit_exact(dev, seg, with_offsets):
    df = np.asarray(seg.term_df)
    tids = [int(t) for t in np.argsort(-df)[:5]] + [
        seg.term_id("t400"), seg.term_id("t401"), -1]
    cs, cn = (torch.from_numpy(a).to(dev) for a in compute_cells(seg, tids))
    ex = Executor(seg, dev)
    before = kernels.launches["decode"]
    got = materialize_freq_tiles(ex.bmeta, ex.planes, cs, cn,
                                 with_offsets=with_offsets)
    want = materialize_freq_tiles_ref(ex.bmeta, ex.planes, cs, cn,
                                      with_offsets=with_offsets)
    torch.cuda.synchronize()
    assert kernels.launches["decode"] == before + 1
    for g, w in zip(got if with_offsets else (got,),
                    want if with_offsets else (want,)):
        assert torch.equal(g, w)
    tiles = got[0] if with_offsets else got
    assert tiles.max().item() > 255  # wide freq fields were decoded


@pytest.mark.parametrize("case,with_offsets", [
    ("subset", False), ("subset", True), ("empty-cells", False),
    ("empty-cells", True),
])
def test_decode_kernel_windows_and_empty_cells(dev, seg, case, with_offsets):
    """K1 on a gathered subset of windows in another order (window_base
    [2, 0]) and on cells emptied beside an unknown term's (they write
    zeros), both output modes: bit-equal to the plain version."""
    df = np.asarray(seg.term_df)
    tids = [int(t) for t in np.argsort(-df)[:3]] + [
        seg.term_id("t400"), -1, seg.term_id("t401")]
    cs, cn = compute_cells(seg, tids)
    base = None
    if case == "subset":
        base = torch.tensor([2, 0], dtype=torch.int32, device=dev)
        cs, cn = cs[[2, 0]], cn[[2, 0]]
    else:
        cn[1, :] = 0
        cn[:, 0] = 0
    cs, cn = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (cs, cn))
    ex = Executor(seg, dev)
    args = (ex.bmeta, ex.planes, cs, cn, base)
    got = materialize_freq_tiles(*args, with_offsets=with_offsets)
    want = materialize_freq_tiles_ref(*args, with_offsets=with_offsets)
    torch.cuda.synchronize()
    for g, w in zip(got if with_offsets else (got,),
                    want if with_offsets else (want,)):
        assert torch.equal(g, w)
    tiles = got[0] if with_offsets else got
    if case == "empty-cells":
        assert not tiles[1].any() and not tiles[:, 0].any()
    assert tiles.any()


@pytest.mark.parametrize("with_offsets", [False, True])
def test_decode_kernel_wide_blocks(dev, with_offsets):
    """K1 where a 2048-doc range meets 40 postings blocks (more than a
    builder's 18, so it takes them in several passes) whose plane rows
    span more than it stages (so it reads them directly): bit-equal to
    the plain version (tests/torch_blocks.py)."""
    bmeta, planes, cs, cn = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                             for a in wide_blocks())
    planes = planes.view(torch.int32)
    got = materialize_freq_tiles(bmeta, planes, cs, cn,
                                 with_offsets=with_offsets)
    want = materialize_freq_tiles_ref(bmeta, planes, cs, cn,
                                      with_offsets=with_offsets)
    torch.cuda.synchronize()
    for g, w in zip(got if with_offsets else (got,),
                    want if with_offsets else (want,)):
        assert torch.equal(g, w)
    tiles = got[0] if with_offsets else got
    assert (tiles[0, 0].reshape(-1)[:2048] > 0).sum() > 18 * 48
    assert tiles[1, 0].any() and not tiles[:, 1].any()


def test_decode_kernel_writes_a_cache_view(dev, seg, hot_cfg):
    """K1 into a strided destination (terms 2..4 of a 6-term cache, window
    major) equals the plain version and leaves the rest untouched; the
    executor's hot-term planes, built in place chunk by chunk, equal the
    plain version over every cached term."""
    ex = Executor(seg, dev)
    order = sorted(ex._hot, key=ex._hot.get)
    assert len(order) > 8  # more than one chunk
    put = lambda a: torch.from_numpy(a).to(dev)
    cs, cn = map(put, compute_cells(seg, order))
    want = materialize_freq_tiles_ref(ex.bmeta, ex.planes, cs, cn)
    assert torch.equal(ex.tf_planes, want.transpose(0, 1))
    big = torch.full((6, seg.n_windows, 128, 128), 7.0, device=dev)
    sub = (ex.bmeta, ex.planes, cs[:, :3].contiguous(), cn[:, :3].contiguous())
    got = materialize_freq_tiles(*sub, out=big[2:5].transpose(0, 1))
    torch.cuda.synchronize()
    assert got.data_ptr() == big[2].data_ptr()
    assert torch.equal(big[2:5], want[:, :3].transpose(0, 1))
    assert (big[:2] == 7).all() and (big[5:] == 7).all()


def _flat_batch(seg, ex, dev, rows, flags, kmin, cached, seed):
    """Flat-kernel inputs: one query row per entry of `rows` (term ids, -1
    for a padding slot); the terms in `cached` read their hot-term planes.
    Returns (cs, cn, weights, flags, kmin, cids) on the card."""
    B, T = len(rows), len(rows[0])
    cs = np.zeros((seg.n_windows, B * T), np.int32)
    cn = np.zeros_like(cs)
    cids = np.full(B * T, -1, np.int32)
    for b, tids in enumerate(rows):
        c_s, c_n = compute_cells(seg, tids)
        cs[:, b * T : (b + 1) * T] = c_s
        cn[:, b * T : (b + 1) * T] = c_n
        cids[b * T : (b + 1) * T] = [ex._hot[t] if t in cached else -1
                                     for t in tids]
    cn = cn * (cids[None, :] < 0)
    w = np.random.default_rng(seed).uniform(0.5, 3.0, size=(B, T))
    return [torch.from_numpy(np.asarray(a, dt)).to(dev) for a, dt in (
        (cs, np.int32), (cn, np.int32), (w, np.float32),
        (flags, np.int32), (kmin, np.int32), (cids, np.int32))]


def _flat_shapes(seg):
    """K2 stress shapes over the test segment's terms by df: (rows,
    flags, kmin, cached terms); -1 is a padding slot (kmin T + 1 on a
    padding row)."""
    df = np.asarray(seg.term_df)
    top = [int(t) for t in np.argsort(-df)]
    rare, sparse = seg.term_id("t400"), seg.term_id("t401")
    return {
        # one cached plane in every query of the group
        "shared-plane": (
            [[top[0], top[i]] for i in (3, 5, 8, 13, 21)] + [[top[0], -1]],
            [[1, 1], [1, 4], [1, 2], [4, 1], [1, 1], [1, 0]],
            [2, 1, 1, 1, 1, 1], {top[0]}),
        # every slot decoded: dense cells that cross every chunk boundary
        "t8-decoded": (
            [top[:8], top[4:12], [-1] * 8],
            [[1] * 8, [1, 1, 2, 4, 4, 1, 2, 4], [0] * 8], [3, 2, 9], set()),
        "pad-rows": (
            [[top[1], top[2], rare, sparse], [-1] * 4, [top[0], top[6], -1,
                                                        -1], [-1] * 4],
            [[1, 4, 1, 2], [0] * 4, [1, 1, 0, 0], [0] * 4], [2, 5, 1, 5],
            {top[0], top[1]}),
        "t1": ([[top[1]], [rare], [-1]], [[1], [1], [0]], [1, 1, 2],
               {top[1]}),
        "t2": ([[top[2], top[7]], [top[0], sparse], [-1, -1]],
               [[1, 1], [1, 2], [0, 0]], [1, 1, 3], {top[0], top[2]}),
    }


@pytest.mark.parametrize("scorer", ["bm25", "tfidf", "trivial"])
@pytest.mark.parametrize("shape", ["shared-plane", "t8-decoded", "pad-rows",
                                   "t1", "t2"])
def test_flat_kernel_stress_shapes(dev, seg, hot_cfg, shape, scorer):
    """K2 against its plain version with deletions and n_docs ending
    mid-chunk: scores and sub-block maxima, -inf positions exact; padding
    rows all -inf."""
    ex = Executor(seg, dev)
    ex.set_masked_local_docs(np.arange(1, seg.n_docs, 7))
    assert seg.n_docs % 2048
    rows, flags, kmin, cached = _flat_shapes(seg)[shape]
    assert cached <= set(ex._hot)
    cs, cn, w, fl, km, cids = _flat_batch(seg, ex, dev, rows, flags, kmin,
                                          cached, seed=len(shape))
    args = (ex.bmeta, ex.planes, cs, cn, w, fl, km, cids, ex.tf_planes,
            seg.n_docs, ex._deleted_tiles)
    before = kernels.launches["flat"]
    got = fused_flat_score_tiles(*args, scorer_name=scorer)
    want = fused_flat_score_tiles_ref(*args, scorer_name=scorer)
    torch.cuda.synchronize()
    assert kernels.launches["flat"] == before + 1
    assert_scores(got[0], want[0])
    assert_scores(got[1], want[1])
    assert torch.isfinite(want[0]).any()
    T = len(rows[0])
    for b, k in enumerate(kmin):
        if k > T:
            assert torch.isneginf(got[0][b]).all()


def test_flat_kernel_caps_slots(dev, seg):
    """The flat kernel takes at most 8 slots a query: T = 9 raises on the
    card, while the plain version (CPU tensors) takes any T."""
    ex = Executor(seg, "cpu")
    rows = [[int(t) for t in np.argsort(-np.asarray(seg.term_df))[:9]]]
    cs, cn, w, fl, km, cids = _flat_batch(seg, ex, "cpu", rows, [[1] * 9],
                                          [2], set(), seed=9)
    args = (ex.bmeta, ex.planes, cs, cn, w, fl, km, cids, ex.tf_planes,
            seg.n_docs, None)
    scores, _ = fused_flat_score_tiles(*args, scorer_name="bm25")
    assert torch.isfinite(scores).any()
    on_card = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError):
        fused_flat_score_tiles(*on_card, scorer_name="bm25")


@pytest.mark.parametrize("scorer", ["bm25", "tfidf", "trivial"])
def test_score_kernels_match_plain(dev, seg, hot_cfg, scorer):
    ex = Executor(seg, dev)
    assert ex._hot
    ex.set_masked_local_docs(np.arange(0, seg.n_docs, 5))
    kinds = set()
    for g in ex.plan_batch(QUERIES, scorer=scorer):
        if g.kind == "dense":
            continue
        kinds.add(g.kind)
        a = {n: torch.from_numpy(v).to(dev) for n, v in g.arrays.items()}
        common = (ex.bmeta, ex.planes, a["cs"], a["cn"], a["weights"])
        if g.kind == "flat":
            tail = (a["flags"], a["kmin"], a["cids"], ex.tf_planes,
                    seg.n_docs, ex._deleted_tiles)
            got = fused_flat_score_tiles(*common, *tail, scorer_name=scorer)
            want = fused_flat_score_tiles_ref(*common, *tail,
                                              scorer_name=scorer)
        else:
            tail = (a["cids"], ex.tf_planes, seg.n_docs, ex._deleted_tiles)
            got = fused_score_tiles(*common, *tail, tape=g.tape,
                                    scorer_name=scorer)
            want = fused_score_tiles_ref(*common, *tail, tape=g.tape,
                                         scorer_name=scorer)
        torch.cuda.synchronize()
        assert_scores(got[0], want[0])
        assert_scores(got[1], want[1])
    assert kinds == {"flat", "fused"}


def test_executor_cuda_equals_cpu(dev, seg, hot_cfg):
    masked = np.arange(3, seg.n_docs, 11)
    out = []
    for d in (dev, "cpu"):
        ex = Executor(seg, d)
        ex.set_masked_local_docs(masked)
        out.append(ex.search_batch(QUERIES, k=10))
    for q, g, w in zip(QUERIES, *out):
        assert [r.doc_id for r in g] == [r.doc_id for r in w], q
        np.testing.assert_allclose([r.score for r in g],
                                   [r.score for r in w], rtol=RTOL, atol=0)


def test_main_path_counts_every_kernel(dev, seg, hot_cfg):
    kernels.reset_launches()
    ex = Executor(seg, dev)
    ex.warmup(QUERIES)
    assert all(kernels.launches[k] > 0 for k in ("decode", "flat", "tape"))
    pex = Executor(make_phrase_segment(), dev)
    assert pex._posmask_enabled
    pex.warmup(['"t0 t1"', '"t5 t6 t7"'])
    assert kernels.launches["posmask"] > 0
    assert kernels.launches["phrase"] > 0


def make_phrase_segment(seed=13, n_docs=40_000, vocab=60):
    """Short docs (positions below 128) over 3 windows with forced
    bigrams and trigrams, for the posmask path."""
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, vocab + 1)
    zipf /= zipf.sum()
    docs = []
    for d in range(n_docs):
        toks = list(rng.choice(vocab, size=int(rng.integers(3, 40)), p=zipf))
        if d % 3 == 0:
            toks[1:3] = [0, 1]
        if d % 7 == 0:
            toks[0:3] = [5, 6, 7]
        docs.append(toks)
    bounds = np.zeros(n_docs + 1, np.int64)
    np.cumsum([len(d) for d in docs], out=bounds[1:])
    sess = SegmentIndexSession()
    sess.bulk_index_ids(np.arange(n_docs) * 3 + 1, np.concatenate(docs),
                        bounds, [f"t{i}" for i in range(vocab)])
    return sess.commit()


@pytest.mark.parametrize("pw_words", [1, 3, 4, 11])
def test_posmask_kernel_bit_exact(dev, seg, pw_words):
    """K4 against its plain version: heavy-freq runs, a sparse term, an
    unknown term, a zeroed cell; PW = 1 (8192-doc ranges), 3 (the bench's,
    2048-doc ranges) and 11 (512-doc ranges)."""
    df = np.asarray(seg.term_df)
    tids = [int(t) for t in np.argsort(-df)[:4]] + [
        seg.term_id("t400"), seg.term_id("t401"), -1, int(np.argsort(-df)[9])]
    cs, cn = compute_cells(seg, tids)
    cn[:, 7] = 0
    cs, cn = (torch.from_numpy(a).to(dev) for a in (cs, cn))
    ex = Executor(seg, dev)
    before = kernels.launches["posmask"]
    args = (ex.bmeta, ex.planes, ex.hit_pw, ex.hit_off, cs, cn, pw_words)
    got = materialize_posmask_tiles(*args)
    want = materialize_posmask_tiles_ref(*args)
    torch.cuda.synchronize()
    assert kernels.launches["posmask"] == before + 1
    assert torch.equal(got, want)
    assert (want[:, :, -1] != 0).any()


PHRASE_QUERIES = [
    '"t0 t1"', '"t5 t6 t7"', '"t1 t0"', '"t6 t7"', '"t3 t3"', '"t50 t51"',
    '"t0 t1" OR t9', 't2 "t0 t1"', 't4 NOT "t5 t6"', '("t0 t1" t3) OR t8',
    "t0 t1", "t2 OR t40",
]


@pytest.mark.parametrize("path", ["posmask", "lazy", "host"])
def test_phrase_executor_cuda_equals_cpu(dev, path):
    """Every phrase route (compound groups ride along in each) on the card
    equals the CPU executor: ids exact, scores within 2 ulp."""
    pseg = make_phrase_segment()
    cfg = get_config()
    saved = (cfg.use_posmask, cfg.posmask_min_df)
    configure(use_posmask=path == "posmask", posmask_min_df=3000)
    try:
        out, kinds = [], []
        for d in (dev, "cpu"):
            ex = Executor(pseg, d)
            ex.set_masked_local_docs(np.arange(5, pseg.n_docs, 13))
            if path == "host":
                ex._phrase_fcaps = lambda *a: None
            kinds.append({g.kind for g in ex.plan_batch(PHRASE_QUERIES)})
            out.append(ex.search_batch(PHRASE_QUERIES, k=10))
    finally:
        configure(use_posmask=saved[0], posmask_min_df=saved[1])
    assert kinds[0] == kinds[1] and "phrase" in kinds[0]
    assert {"posmask": "posph", "lazy": "lazyph",
            "host": "lazyhost"}[path] in kinds[0]
    for q, g, w in zip(PHRASE_QUERIES, *out):
        assert [r.doc_id for r in g] == [r.doc_id for r in w], q
        np.testing.assert_allclose([r.score for r in g],
                                   [r.score for r in w], rtol=RTOL, atol=0)
    assert sum(1 for w in out[1] if w) >= len(PHRASE_QUERIES) - 2


# (B, K): search()'s one phrase, the mix's bigram and trigram groups, and
# the longest phrase a query holds (MAX_PHRASE_SIZE)
PHRASE_SHAPES = [(1, 2), (12, 2), (6, 3), (3, 16)]


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("pw_words", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", PHRASE_SHAPES)
def test_phrase_score_kernel_matches_plain(dev, shape, pw_words, dead):
    """K5 against its plain version over three windows, each scorer with
    its own split of the members between K4's words and the hot cache
    (masks only, both, cache only): scores and sub-block maxima within
    2 ulp, one launch a call."""
    B, K = shape
    for scorer, split in (("bm25", (K + 1, 0)), ("tfidf", (2, K)),
                          ("trivial", (0, 3))):
        group = phrase_group(B * 100 + K * 10 + pw_words, 3, B, K, pw_words,
                             *split, dead, device=dev)
        before = kernels.launches["phrase"]
        got = phrase_score_tiles(*group, scorer_name=scorer)
        want = phrase_score_tiles_ref(*group, scorer_name=scorer)
        torch.cuda.synchronize()
        assert kernels.launches["phrase"] == before + 1
        assert got[0].shape == (B, 3, 128, 128) and got[1].shape == (B, 3, 16)
        for g, w in zip(got, want):
            assert_scores(g, w)
        assert torch.isfinite(want[0]).any()


def test_posph_groups_launch_one_phrase_kernel_each(dev):
    """Pure phrases on the posmask route, some members in the hot cache,
    with deleted docs: the card's top-k equals the CPU executor's (the
    per-query loop of the plain version), one K5 launch a posph group;
    match_ids of a phrase equals the CPU's."""
    pseg = make_phrase_segment()
    queries = ['"t0 t1"', '"t5 t6 t7"', '"t1 t0"', '"t6 t7"', '"t3 t3"',
               '"t50 t51"', '"t5 t6"', '"t0 t1 t2 t3"']
    cfg = get_config()
    saved = (cfg.use_posmask, cfg.posmask_min_df)
    configure(use_posmask=True, posmask_min_df=6000)
    try:
        out, ids = [], []
        for d in (dev, "cpu"):
            ex = Executor(pseg, d)
            ex.set_masked_local_docs(np.arange(5, pseg.n_docs, 13))
            groups = ex.plan_batch(queries)
            assert {g.kind for g in groups} == {"posph"}
            cidx = np.concatenate([g.ctx["cidx"] for g in groups])
            assert (cidx >= 0).any() and (cidx < 0).any()
            kernels.reset_launches()
            out.append(ex.search_batch(queries, k=10))
            if d == dev:
                torch.cuda.synchronize()
                assert kernels.launches["phrase"] == len(groups)
            ids.append(ex.match_ids('"t5 t6"'))
    finally:
        configure(use_posmask=saved[0], posmask_min_df=saved[1])
    for q, g, w in zip(queries, *out):
        assert [r.doc_id for r in g] == [r.doc_id for r in w], q
        np.testing.assert_allclose([r.score for r in g],
                                   [r.score for r in w], rtol=RTOL, atol=0)
    assert sum(1 for w in out[1] if w) >= len(queries) - 2
    np.testing.assert_array_equal(ids[0], ids[1])
    assert len(ids[1]) > 0


def test_lazy_workspace_fixes_the_peak(dev, monkeypatch):
    """Once a first lazy batch has reserved the executor's workspace, two
    lazy batches of different sizes raise max_memory_allocated by the same
    bytes: with a workspace of one row, each chunk is one row of the same
    phrase, whatever the group's size (an unchunked group held every row
    at once). Their answers equal the CPU executor's."""
    from trinity_tpu_torch.exec import executor as executor_mod

    pseg = make_phrase_segment()
    q = '"t0 t1"'
    cfg = get_config()
    saved = cfg.use_posmask
    configure(use_posmask=False)
    try:
        ex = Executor(pseg, dev)
        (g,) = ex.plan_batch([q])
        assert g.kind == "lazyph"
        monkeypatch.setattr(
            executor_mod, "LAZY_WORKSPACE_BYTES",
            executor_mod._lazy_bytes(pseg.n_windows, 1, g.T, 2, g.ctx["C2"],
                                     True))
        ex.search_batch([q] * 2, k=10)
        rises, out = [], []
        for m in (3, 6):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            out.append(ex.search_batch([q] * m, k=10))
            torch.cuda.synchronize()
            rises.append(torch.cuda.max_memory_allocated(dev) - base)
        want = Executor(pseg, "cpu").search_batch([q], k=10)[0]
    finally:
        configure(use_posmask=saved)
    assert rises[0] == rises[1] > 0
    assert ex._lazy_ws.numel() == executor_mod.LAZY_WORKSPACE_BYTES
    assert len(want) == 10
    for res in out[0] + out[1]:
        assert [r.doc_id for r in res] == [r.doc_id for r in want]
        np.testing.assert_allclose([r.score for r in res],
                                   [r.score for r in want], rtol=RTOL, atol=0)


def test_posmask_kernel_writes_a_cache_view(dev):
    """K4 into a strided destination (members 2..4 of a 6-member cache)
    equals the plain version and leaves the rest of the cache untouched;
    the executor's posmask hot cache, built in place chunk by chunk,
    equals the plain version over every cached term."""
    from trinity_tpu_torch.ops.postings import compute_cells

    pseg = make_phrase_segment()
    cfg = get_config()
    saved = cfg.posmask_min_df
    configure(posmask_min_df=1)
    try:
        ex = Executor(pseg, dev)
        order = sorted(ex._pos_hot, key=ex._pos_hot.get)
        assert len(order) > 8  # more than one chunk
        cache = ex.pos_planes
    finally:
        configure(posmask_min_df=saved)
    PW = ex._pw_words
    put = lambda a: torch.from_numpy(a).to(dev)
    cs, cn = map(put, compute_cells(pseg, order))
    args = (ex.bmeta, ex.planes, ex.hit_pw, ex.hit_off, cs, cn, PW)
    assert torch.equal(cache, materialize_posmask_tiles_ref(*args))
    big = torch.full((pseg.n_windows, 6, PW, 128, 128), 7, dtype=torch.int32,
                     device=dev)
    sub = (ex.bmeta, ex.planes, ex.hit_pw, ex.hit_off, cs[:, :3].contiguous(),
           cn[:, :3].contiguous(), PW)
    got = materialize_posmask_tiles(*sub, out=big[:, 2:5])
    torch.cuda.synchronize()
    assert got.data_ptr() == big[:, 2:5].data_ptr()
    assert torch.equal(big[:, 2:5], materialize_posmask_tiles_ref(*sub))
    assert (big[:, :2] == 7).all() and (big[:, 5:] == 7).all()


def _tape_batch(seg, ex, dev, n_used, cached):
    """A B = 2, T = 8 batch whose slots hold the segment's top terms, the
    first `cached` of each row read from the hot planes."""
    df = np.asarray(seg.term_df)
    top = [int(t) for t in np.argsort(-df)[:16]]
    B, T = 2, 8
    cs = np.zeros((seg.n_windows, B * T), np.int32)
    cn = np.zeros_like(cs)
    cids = np.full(B * T, -1, np.int32)
    for b in range(B):
        tids = top[b * 3 : b * 3 + n_used]
        c_s, c_n = compute_cells(seg, tids)
        cs[:, b * T : b * T + n_used] = c_s
        cn[:, b * T : b * T + n_used] = c_n
        for s_, t in enumerate(tids[:cached]):
            cids[b * T + s_] = ex._hot.get(t, -1)
    cn = cn * (cids[None, :] < 0)
    rng = np.random.default_rng(n_used)
    w = rng.uniform(0.5, 3.0, size=(B, 16)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (cs, cn, w, cids)]


def _tok(s):
    return ("tok", s, s)


def _chain(slots):
    """A right-leaning and/or chain over the slots: its depth is their
    count, so long chains need the 8- and 16-register kernels."""
    node = _tok(slots[-1])
    for i, s in enumerate(reversed(slots[:-1])):
        node = ("and" if i % 2 else "or", _tok(s), node)
    return node


TAPES_BY_USED = {
    1: [("opt", _tok(0)), ("not", _tok(0), ("unot", _tok(0))),
        ("some", 1, (_tok(0), _tok(0)))],
    4: [("or", ("and", _tok(0), _tok(1)), ("and", _tok(2), _tok(3))),
        ("some", 2, (_tok(0), ("not", _tok(1), _tok(2)), _tok(3), _tok(0)))],
    8: [("or", ("and", _tok(0), ("opt", _tok(1))),
         ("not", ("some", 2, tuple(_tok(i) for i in range(2, 8))),
          ("unot", _tok(0)))),
        _chain(list(range(8))),
        _chain(list(range(8)) * 2)],
}


@pytest.mark.parametrize("n_used", [1, 4, 8])
def test_tape_kernel_register_programs(dev, seg, hot_cfg, n_used):
    """K3 at U = 1, 4 and 8 used slots, with programs of 4, 8 and 16
    registers (k-of-n, NOT, optional, unary NOT, slot reuse), cached and
    decoded slots, deletions: scores and maxima equal the plain version."""
    ex = Executor(seg, dev)
    ex.set_masked_local_docs(np.arange(0, seg.n_docs, 9))
    cs, cn, w, cids = _tape_batch(seg, ex, dev, n_used, cached=n_used // 2)
    nregs = set()
    for tape in TAPES_BY_USED[n_used]:
        assert len(tape_used_slots(tape)) == n_used
        nregs.add(encode_tape(tape, tape_used_slots(tape))[1])
        args = (ex.bmeta, ex.planes, cs, cn, w, cids, ex.tf_planes,
                seg.n_docs, ex._deleted_tiles)
        got = fused_score_tiles(*args, tape=tape, scorer_name="bm25")
        want = fused_score_tiles_ref(*args, tape=tape, scorer_name="bm25")
        torch.cuda.synchronize()
        assert_scores(got[0], want[0])
        assert_scores(got[1], want[1])
        assert torch.isfinite(want[0]).any()
    if n_used == 8:
        assert max(nregs) > 8  # the 16-register kernel ran


def test_decode_kernel_pruned_chunk(dev, seg):
    """K1 at the pruned search's chunk shape: gathered ascending windows,
    the short last chunk padded by a duplicate of its edge window with
    zeroed cells, and a resolved query's cells zeroed (exec/pruned.py's
    chunk_cells on a flat group, chunk_windows=2 over 3 windows): bit-equal
    to the plain version, and zero where the cells are."""
    from trinity_tpu_torch.exec.planning import _plan_for_text
    from trinity_tpu_torch.exec.pruned import chunk_cells, plan_pruned

    ex = Executor(seg, dev)
    plans = [_plan_for_text(q)[1] for q in ("t0 t1", "t2 t5", "t3 t400")]
    (g,), _ = plan_pruned(ex, plans, "bm25")
    resolved = np.array([True, False, False, True])
    for c0 in (0, 2):
        selp, csel, nsel = chunk_cells(g, c0, 2, resolved)
        args = [torch.from_numpy(a).to(dev) for a in (csel, nsel, selp)]
        got = materialize_freq_tiles(ex.bmeta, ex.planes, *args)
        want = materialize_freq_tiles_ref(ex.bmeta, ex.planes, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert not got[:, : g.T].any() and got.any()
    assert selp[0] == selp[1] and not got[1].any()  # the padded chunk


def test_collection_cuda_equals_cpu(dev, seg, hot_cfg):
    """A three-generation collection (the base segment, 4,000 updated or
    new documents, an erase-only generation) on the card equals its CPU
    twin: search_batch, search_pruned_batch and match_ids."""
    from trinity_tpu_torch import IndexSourcesCollection

    rng = np.random.default_rng(3)
    upd = rng.choice(seg.doc_map, 3500, replace=False)
    ids = np.sort(np.concatenate([upd[:3000], 10**6 + np.arange(1000)]))
    bounds = np.zeros(len(ids) + 1, np.int64)
    np.cumsum(rng.integers(3, 12, size=len(ids)), out=bounds[1:])
    toks = rng.integers(0, 60, size=int(bounds[-1]))
    sess = SegmentIndexSession()
    sess.bulk_index_ids(ids, toks, bounds, [f"t{i}" for i in range(60)])
    for d in upd[:3000]:
        sess.erase(int(d))
    gen2 = sess.commit()
    sess = SegmentIndexSession()
    for d in upd[3000:]:
        sess.erase(int(d))
    gen3 = sess.commit()
    out = []
    for d in (dev, "cpu"):
        coll = IndexSourcesCollection(device=d)
        for gen, s in enumerate((seg, gen2, gen3), start=1):
            coll.add_segment(s, gen)
        coll.commit()
        out.append((coll.search_batch(QUERIES, k=10),
                    coll.search_pruned_batch(QUERIES, k=10),
                    [coll.match_ids(q) for q in QUERIES[:4]]))
    (gb, gp, gm), (wb, wp, wm) = out
    for q, g, p, w in zip(QUERIES, gb, gp, wb):
        assert [r.doc_id for r in g] == [r.doc_id for r in w], q
        np.testing.assert_allclose([r.score for r in g],
                                   [r.score for r in w], rtol=RTOL, atol=0)
        assert [(r.doc_id, r.score) for r in p] == [
            (r.doc_id, r.score) for r in g], q
    for a, b in zip(gm, wm):
        np.testing.assert_array_equal(a, b)
    assert any(set(r.doc_id for r in res) & set(ids.tolist()) for res in gb)


def _rich_stream(ex, q, cap=3000):
    from trinity_tpu_torch import AbortSearch, exec_rich

    out = []

    def on_match(md):
        out.append((md.doc_id, [(t.term, t.freq, [h.pos for h in t.hits])
                                for t in md.matched_terms]))
        if len(out) == cap:
            raise AbortSearch

    n = exec_rich(ex, q, on_match)
    return out, n


def test_exec_rich_cuda_equals_cpu(dev):
    """Rich-match on the card (K1 with offsets, the relaxed tape, the
    docid-ordered compaction) delivers the CPU executor's stream, under a
    deletion registry, and its ids are match_ids'; it launches K1."""
    pseg = make_phrase_segment()
    masked = np.arange(5, pseg.n_docs, 13)
    out = []
    for d in (dev, "cpu"):
        ex = Executor(pseg, d)
        ex.set_masked_local_docs(masked)
        before = kernels.launches["decode"]
        out.append([_rich_stream(ex, q) for q in PHRASE_QUERIES])
        if d == dev:
            assert kernels.launches["decode"] - before == len(PHRASE_QUERIES)
            ids = [ex.match_ids(q) for q in PHRASE_QUERIES]
    for q, g, w, i in zip(PHRASE_QUERIES, *out, ids):
        assert g == w, q
        assert [m[0] for m in g[0]] == i[:len(g[0])].tolist(), q
    assert sum(1 for g in out[0] if g[1]) >= len(PHRASE_QUERIES) - 2


@pytest.mark.parametrize("n_tokens", [8, 64])
def test_intersect_cuda_equals_cpu(dev, seg, n_tokens):
    """intersect's presence words on the card (K1 at T = tokens, up to 64,
    bit 63 included) give the CPU executor's (mask, count) list."""
    from trinity_tpu_torch.query.intersect import intersect

    toks = [f"t{i}" for i in range(n_tokens)]
    before = kernels.launches["decode"]
    got = intersect(Executor(seg, dev), toks)
    assert kernels.launches["decode"] == before + 1
    assert got == intersect(Executor(seg, "cpu"), toks)
    assert got and any(m >> (n_tokens - 1) for m, _ in got)


def test_threaded_warmup_then_strict_seal(dev, seg, hot_cfg):
    """warmup(threads=8) on the card builds each hot cache once; after a
    strict seal the same queries, pipelined and blocking, miss nothing."""
    from trinity_tpu_torch.utils.seal import (
        post_seal_misses,
        seal_programs,
        unseal_programs,
    )

    ex = Executor(seg, dev)
    builds = []
    build = ex._build_tf_planes
    ex._build_tf_planes = lambda: builds.append(1) or build()
    w = ex.warmup(QUERIES, threads=8)
    assert builds == [1] and w["variants"] == len(QUERIES) + 1
    before = post_seal_misses()
    seal_programs(strict=True)
    try:
        ex.finish_batch(ex.launch_batch(QUERIES))
        for q in QUERIES:
            ex.search(q)
    finally:
        unseal_programs()
    assert post_seal_misses() == before


def test_percolator_cuda_equals_cpu(dev):
    """The percolator on the card (the torch postfix evaluation over the
    staged programs) equals its CPU run, in match_batch, match_stream and
    chunked; the programs are staged once per registration epoch."""
    from trinity_tpu_torch import Percolator

    rng = np.random.default_rng(4)
    texts = []
    for i in range(1500):
        a, b, c, d = (int(x) for x in rng.integers(0, 300, 4))
        texts.append([f"w{a} w{b}", f"w{a} OR w{b} OR w{c}", f"w{a} NOT w{b}",
                      f"[w{a}, w{b}, w{c}, w{d}]/2", f'"w{a} w{b}"',
                      f"(w{a} w{b}) OR <w{c}>"][i % 6])
    batches = [[[f"w{int(x)}" for x in rng.integers(0, 300, 40)]
                for _ in range(256)] for _ in range(3)]
    out = []
    for d in (dev, "cpu"):
        p = Percolator(device=d)
        for t in texts:
            p.register(t)
        staged = p._epoch()[2]
        out.append([p.match_batch(b) for b in batches]
                   + list(p.match_stream(batches)))
        assert p._epoch()[2] is staged
    for g, w in zip(*out):
        np.testing.assert_array_equal(g, w)
    assert out[0][0].any() and not out[0][0].all()
    from trinity_tpu_torch import percolator as perc

    ops, uniq = p._pack()
    inc, ph = p.build_incidence(batches[0], uniq)
    np.testing.assert_array_equal(
        perc.eval_programs(ops, inc, ph, device=dev, chunk=13), out[1][0])


def test_mesh_cuda_equals_single_executor(dev, seg, hot_cfg):
    """Four shards on one card equal the single executor on the unsharded
    segment (ids and scores bit-equal), under a mask too; each live shard
    launches the kernels."""
    from trinity_tpu_torch.parallel import MeshExecutor

    ex = Executor(seg, dev)
    mex = MeshExecutor(seg, devices=dev, n_shards=4)
    assert [d.type for d in mex.devices] == ["cuda"] * 4
    for masked in (None, np.arange(0, seg.n_docs, 7)):
        ex.set_masked_local_docs(masked)
        mex.set_masked_local_docs(masked)
        before = kernels.launches["flat"]
        got = mex.search_batch(QUERIES, k=10)
        assert kernels.launches["flat"] > before
        want = ex.search_batch(QUERIES, k=10)
        for q, g, w in zip(QUERIES, got, want):
            assert [(r.doc_id, r.score) for r in g] == [
                (r.doc_id, r.score) for r in w], q
        pruned = mex.search_pruned_batch(QUERIES, k=10)
        for q, g, w in zip(QUERIES, pruned, want):
            assert [(r.doc_id, r.score) for r in g] == [
                (r.doc_id, r.score) for r in w], q
        for q in QUERIES[:4]:
            np.testing.assert_array_equal(mex.match_ids(q), ex.match_ids(q))
