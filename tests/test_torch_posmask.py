"""Port posmask (trinity_tpu_torch/ops/posmask.py) against the JAX package.

- materialize_posmask_tiles_ref (the plain torch version of the CUDA K4
  kernel) is bit-equal to the JAX materialize_posmask_tiles, run in
  interpret mode as the JAX package's own tests run it on the CPU, on a
  one-window segment with forced phrases and a three-window segment whose
  docs reach position 120 (four words per doc), long same-term runs that
  cross 128-value position groups, cached (zeroed) cells and an unknown
  term. On CPU tensors the wrapper runs that plain version and counts no
  kernel launch.
- phrase_freq_from_masks equals the JAX function on random words (bit 31
  set, shifts across word boundaries, a repeated member); its SWAR popcount
  equals np.bitwise_count.
- The wrapper writes into a destination view (a slice of a larger cache),
  and the executor's hot cache, filled in place chunk by chunk, equals the
  plain version; posmask_bytes and decode_bytes give the byte counts
  worked out by hand.
- phrase_score_tiles_ref (the plain version of the phrase score kernel)
  equals the executor's former composition (phrase_freq_from_masks, then
  score_tile, -inf outside live matches, then the sub-block amax) bit for
  bit: K = 2, 3, 5, 16, PW = 1-4, every scorer, with and without deleted
  docs, members repeated and mixed between masks and cache; its wrapper
  raises on a bad dtype, shape, member count or word count;
  phrase_score_bytes gives the count worked out by hand.
Integer outputs: exact equality. Segments are built by both packages'
builders (held equal); each side reads its own package's segment.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trinity_tpu.ops.posmask as ref
import trinity_tpu_torch.ops.posmask as port
from torch_twins import build_pair, bulk_pair, reconfigured
from torch_words import phrase_group
from trinity_tpu.exec import Executor as JaxExecutor
from trinity_tpu_torch import Executor
from trinity_tpu_torch.models.similarity import score_tile
from trinity_tpu_torch.ops.fusedscore import NEG_INF, NSUB, SUB_DOCS
from trinity_tpu_torch.ops.postings import (
    C_BD,
    C_BF,
    C_COUNT,
    C_FIRST,
    C_HITS,
    compute_cells,
    decode_bytes,
)
from trinity_tpu_torch.utils import kernels


def phrased_segment():
    """test_posmask.py's `phrased` corpus: 500 docs, forced bigrams,
    trigrams and repeats; (port segment, reference segment)."""
    def fill(sess):
        rng = np.random.default_rng(91)
        zipf = 1.0 / np.arange(1, 31)
        zipf /= zipf.sum()
        for d in range(1, 501):
            toks = [f"t{int(i)}"
                    for i in rng.choice(30, size=int(rng.integers(6, 50)),
                                        p=zipf)]
            r = rng.random()
            if r < 0.3:
                toks[2:4] = ["t0", "t1"]
            if 0.2 < r < 0.5:
                toks[0:3] = ["t5", "t6", "t7"]
            if r > 0.8:
                toks[1:3] = ["t2", "t2"]
            p = sess.begin(d)
            for pos, t in enumerate(toks, start=1):
                p.insert(t, pos)
            sess.insert(p)

    return build_pair(fill)


def multiwindow_segment():
    """36,000 docs over three windows, 3-120 tokens each; every 97th doc
    holds a run of 60-115 copies of t0 (position runs across groups);
    (port segment, reference segment)."""
    rng = np.random.default_rng(5)
    n_docs, vocab = 36_000, 40
    zipf = 1.0 / np.arange(1, vocab + 1)
    zipf /= zipf.sum()
    docs = []
    for d in range(n_docs):
        n = int(rng.integers(3, 10)) if d % 11 else int(rng.integers(60, 121))
        toks = list(rng.choice(vocab, size=n, p=zipf))
        if d % 97 == 0:
            toks = [0] * int(rng.integers(60, 116)) + toks[:5]
        docs.append(toks)
    bounds = np.zeros(n_docs + 1, np.int64)
    np.cumsum([len(t) for t in docs], out=bounds[1:])
    return bulk_pair(np.arange(n_docs) * 2 + 1, np.concatenate(docs), bounds,
                     [f"t{i}" for i in range(vocab)])


@pytest.fixture(scope="module", params=["phrased", "multiwindow"])
def case(request):
    seg, ref_seg = phrased_segment() if request.param == "phrased" else (
        multiwindow_segment())
    assert seg.positions_distinct
    terms = ["t0", "t1", "t2", "t7", "t29", "zz", "t5", "t3"]
    tids = [seg.term_id(t) for t in terms]
    cs, cn = compute_cells(seg, tids)
    cn[:, 6] = 0  # a cached member: its cell is zeroed
    return (seg, ref_seg), cs, cn


def test_posmask_ref_bit_equal_to_jax(case):
    (seg, ref_seg), cs, cn = case
    jx = JaxExecutor(ref_seg)
    PW = jx._pw_words
    dpr, ppr, gor, need_pos, need_goff = jx._pos_cell_rows(cs, cn)
    rpos = next(rb for rb in ref.RPOS_BUCKETS
                if need_pos <= rb and need_goff <= ref.GOFF_ROWS[rb])
    W, M = cs.shape
    want = np.asarray(ref.materialize_posmask_tiles(
        jnp.asarray(jx._bmeta_h), jnp.asarray(jx._planes_h),
        jnp.asarray(jx._hit_pw_h), jnp.asarray(jx._hit_goff_h),
        *(jnp.asarray(a) for a in (cs, cn, dpr, ppr, gor)),
        n_windows=W, n_members=M, pw_words=PW, rpos_rows=rpos,
        goff_rows=ref.GOFF_ROWS[rpos], interpret=True,
    ))
    ex = Executor(seg, "cpu")
    assert ex._pw_words == PW
    before = dict(kernels.launches)
    got = port.materialize_posmask_tiles(
        ex.bmeta, ex.planes, ex.hit_pw, ex.hit_off, torch.from_numpy(cs),
        torch.from_numpy(cn), PW,
    )
    assert kernels.launches == before
    assert got.dtype == torch.int32 and got.shape == (W, M, PW, 128, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    # non-trivial: bits set in the last word, and bit 31 somewhere
    assert PW >= 2 and (want[:, :, -1] != 0).any() and (want < 0).any()
    assert not want[:, 5:7].any()  # the unknown term and the zeroed cell


def test_phrase_freq_from_masks_equals_jax():
    rng = np.random.default_rng(8)
    W, PW = 2, 3
    words = rng.integers(-(1 << 31), 1 << 31, size=(4, W, PW, 128, 128),
                         dtype=np.int64).astype(np.int32)
    # dense ones so ANDs survive, and a repeated member
    words[1] |= words[0]
    words[2] = words[1]
    for K in (2, 3, 4):
        want = np.asarray(ref.phrase_freq_from_masks(jnp.asarray(words[:K]),
                                                     K, PW))
        got = port.phrase_freq_from_masks(torch.from_numpy(words[:K]), K, PW)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.max() > 0
    # a sequence of member tensors, one passed twice, gives the same result
    seq = [torch.from_numpy(words[0]), torch.from_numpy(words[0])]
    np.testing.assert_array_equal(
        port.phrase_freq_from_masks(seq, 2, PW).numpy(),
        np.asarray(ref.phrase_freq_from_masks(
            jnp.asarray(words[[0, 0]]), 2, PW)),
    )


def test_popcount_equals_numpy():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 32, size=100_000, dtype=np.uint64)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    got = port.popcount32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.bitwise_count(x))


def test_posmask_writes_into_a_cache_view():
    """The wrapper (plain version on the CPU) writes into a strided slice of
    a larger tensor and leaves the rest of it alone; the executor's posmask
    hot cache, built in place chunk by chunk, equals the plain version over
    every cached term."""
    seg, _ = phrased_segment()
    ex = Executor(seg, "cpu")
    PW = ex._pw_words
    tids = [seg.term_id(t) for t in ("t0", "t1", "t2", "t7", "zz")]
    cs, cn = map(torch.from_numpy, compute_cells(seg, tids))
    args = (ex.bmeta, ex.planes, ex.hit_pw, ex.hit_off, cs, cn, PW)
    big = torch.full((seg.n_windows, 8, PW, 128, 128), 7, dtype=torch.int32)
    got = port.materialize_posmask_tiles(*args, out=big[:, 2:7])
    assert got.data_ptr() == big[:, 2:7].data_ptr()
    assert torch.equal(big[:, 2:7], port.materialize_posmask_tiles_ref(*args))
    assert (big[:, :2] == 7).all() and (big[:, 7:] == 7).all()
    with pytest.raises(ValueError):  # a member's words must be contiguous
        port.materialize_posmask_tiles(*args, out=big[:, 2:7].transpose(3, 4))
    with reconfigured(posmask_min_df=1):
        ex = Executor(seg, "cpu")
        order = sorted(ex._pos_hot, key=ex._pos_hot.get)
        assert len(order) > 8  # several chunks
        cache = ex.pos_planes
    cs, cn = map(torch.from_numpy, compute_cells(seg, order))
    assert torch.equal(cache, port.materialize_posmask_tiles_ref(
        ex.bmeta, ex.planes, ex.hit_pw, ex.hit_off, cs, cn, PW))


def test_posmask_bytes_by_hand():
    """One cell, PW = 2, one postings block of 3 postings (zero planes: all
    on its first doc, freq 1) whose runs are elements 126-128 of the
    positions stream: groups 0 (7-bit fields) and 1 (5-bit) are read."""
    bmeta = torch.zeros((2, 128), dtype=torch.int32)
    bmeta.reshape(-1, 8)[0, [C_BD, C_BF, C_FIRST, C_COUNT, C_HITS]] = (
        torch.tensor([3, 2, 5, 3, 126], dtype=torch.int32))
    planes = torch.zeros((8, 128), dtype=torch.int32)
    hit_off = torch.tensor([0, 7, 12, 20], dtype=torch.int32)
    cs = torch.zeros((1, 1), dtype=torch.int32)
    cn = torch.ones((1, 1), dtype=torch.int32)
    words = 1 * 1 * 2 * 16384 * 4
    tables = 2 * 4
    block = 32 + 128 * (3 + 2) // 8
    groups = 128 * (7 + 5) // 8 + 2 * 4
    assert port.posmask_bytes(bmeta, planes, hit_off, cs, cn, 2) == (
        words + tables + block + groups)
    assert decode_bytes(bmeta, cs, cn) == 16384 * 4 + tables + block
    assert decode_bytes(bmeta, cs, cn, True) == 2 * 16384 * 4 + tables + block


def former_composition(masks, cache, members, weights, deleted, scorer):
    """The executor's posmask group before the phrase score kernel: one
    phrase_freq_from_masks a query, score_tile, -inf outside live
    matches, then the sub-block amax."""
    B, K = members.shape
    src = masks if masks is not None else cache
    W, PW = src.shape[0], src.shape[2]
    member = lambda v: masks[:, v] if v >= 0 else cache[:, -1 - v]
    dead = None if deleted is None else deleted.bool()
    rows = []
    for b in range(B):
        freq = port.phrase_freq_from_masks(
            [member(v) for v in members[b].tolist()], K, PW)
        live = freq > 0
        if dead is not None:
            live &= ~dead
        sc = score_tile(scorer, freq.to(torch.float32), weights[b])
        rows.append(torch.where(live, sc, NEG_INF))
    scores = torch.stack(rows)
    return scores, scores.reshape(B, W, NSUB, SUB_DOCS).amax(dim=3)


@pytest.mark.parametrize("scorer", ["bm25", "tfidf", "trivial"])
@pytest.mark.parametrize("PW", [1, 2, 3, 4])
@pytest.mark.parametrize("K", [2, 3, 5, 16])
def test_phrase_score_ref_equals_former_composition(K, PW, scorer):
    kernels.reset_launches()
    for dead, (n_masks, n_cache) in ((False, (K + 1, 0)), (True, (2, K)),
                                     (True, (0, 3))):
        group = phrase_group(K * 10 + PW, 2, 4, K, PW, n_masks, n_cache,
                             dead)
        want = former_composition(*group, scorer)
        got = port.phrase_score_tiles(*group, scorer_name=scorer)
        ref_got = port.phrase_score_tiles_ref(*group, scorer_name=scorer)
        for g, r, w in zip(got, ref_got, want):
            assert g.dtype == torch.float32
            assert torch.equal(g, w) and torch.equal(r, w)
        assert got[1].shape == (4, 2, NSUB)
        fin = torch.isfinite(want[0])
        assert fin.any() and not fin.all()  # matches and -inf both occur
    assert kernels.launches["phrase"] == 0  # CPU tensors: no launch


def test_phrase_score_wrapper_raises():
    masks, cache, members, weights, deleted = phrase_group(1, 1, 2, 3, 2, 2,
                                                           2, True)
    call = lambda **kw: port.phrase_score_tiles(
        **{**dict(masks=masks, cache=cache, members=members, weights=weights,
                  deleted=deleted), **kw}, scorer_name="bm25")
    call()
    with pytest.raises(TypeError):
        call(masks=masks.to(torch.int64))
    with pytest.raises(TypeError):
        call(weights=weights.double())
    with pytest.raises(TypeError):
        call(deleted=deleted.bool())
    with pytest.raises(ValueError):
        call(masks=masks[0])  # 4-D
    with pytest.raises(ValueError):
        call(cache=torch.cat([cache, cache]))  # windows disagree
    with pytest.raises(ValueError):
        call(members=members.reshape(-1))
    with pytest.raises(ValueError):
        call(weights=weights[:1])
    with pytest.raises(ValueError):
        call(deleted=deleted[:, :64])
    with pytest.raises(ValueError):
        call(masks=None, cache=None)
    with pytest.raises(ValueError):  # K above MAX_PHRASE_SIZE
        call(members=torch.zeros((2, 17), dtype=torch.int32))
    with pytest.raises(ValueError):  # PW = 0
        call(masks=masks[:, :, :0], cache=None)
    with pytest.raises(ValueError):  # PW above MAX_PW
        call(masks=torch.zeros((1, 1, port.MAX_PW + 1, 128, 128),
                               dtype=torch.int32), cache=None)


def test_phrase_score_bytes_by_hand():
    """Two queries of three members over W = 2, PW = 3: four distinct
    columns read once, two queries' scores and maxima written, the table,
    the weights and the deletion tiles."""
    masks, cache, _, weights, deleted = phrase_group(2, 2, 2, 3, 3, 3, 2,
                                                     True)
    members = torch.tensor([[0, 1, -1], [1, 1, 2]], dtype=torch.int32)
    words = 4 * 2 * 3 * 16384 * 4
    out = 2 * 2 * (16384 + 16) * 4
    assert port.phrase_score_bytes(masks, cache, members, deleted) == (
        words + out + 6 * 4 + 2 * 4 + 2 * 16384 * 4)
    assert port.phrase_score_bytes(masks, cache, members, None) == (
        words + out + 6 * 4 + 2 * 4)
