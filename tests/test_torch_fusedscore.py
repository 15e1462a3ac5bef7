"""Port fused score (trinity_tpu_torch/ops/fusedscore.py) against JAX.

The plain torch versions of the two CUDA score kernels equal the JAX
package's fused_flat_score_tiles and fused_score_tiles (Pallas, run in
interpret mode as the JAX package's own tests run them on the CPU) on the
same inputs, made from a numpy seed: cached hot-term slots, deletions,
padded batch rows (kmin = T + 1) and a last window cut by n_docs.
Scores and sub-block maxima within 2 ulp (rtol=2.4e-7, atol=0 — the
repo's engine-vs-oracle bound; -inf positions must match exactly).

The port's exact_window_topk equals the JAX one on inputs with heavy ties
across sub-block boundaries: values and ids exactly. The plain versions'
TF-IDF sqrt is correctly rounded (bit-equal to np.sqrt).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trinity_tpu.ops.fusedscore as ref
import trinity_tpu_torch.models.similarity as port_sim
import trinity_tpu_torch.ops.fusedscore as port
from torch_twins import bulk_pair
from trinity_tpu_torch.ops.postings import (
    C_BD,
    C_BF,
    C_COUNT,
    C_FIRST,
    compute_cells,
    materialize_freq_tiles_ref,
    pack_block_meta,
    pad_planes,
)

RTOL = 2.4e-7  # 2 ulp


@pytest.fixture(scope="module")
def inputs():
    """2-window segment (the last window cut by n_docs), 4 queries x 4
    slots: slots 0-1 of every query read hot-term planes, the rest decode."""
    rng = np.random.default_rng(17)
    n_docs, vocab = 27_000, 120
    zipf = 1.0 / np.arange(1, vocab + 1)
    zipf /= zipf.sum()
    lens = rng.integers(2, 12, size=n_docs)
    bounds = np.zeros(n_docs + 1, np.int64)
    np.cumsum(lens, out=bounds[1:])
    seg, _ = bulk_pair(
        np.arange(n_docs), rng.choice(vocab, size=int(bounds[-1]), p=zipf),
        bounds, [f"t{i}" for i in range(vocab)],
    )
    W, B, T = seg.n_windows, 4, 4
    assert W == 2 and seg.n_docs % 16384
    bmeta = pack_block_meta(seg)
    planes = pad_planes(seg.planes)
    hot = [seg.term_id("t0"), seg.term_id("t1")]
    tb, pb = torch.from_numpy(bmeta), torch.from_numpy(planes.view(np.int32))
    hs, hn = (torch.from_numpy(a) for a in compute_cells(seg, hot))
    tf_planes = materialize_freq_tiles_ref(tb, pb, hs, hn).transpose(0, 1)
    terms = [[0, 1, 5, 9], [1, 0, 30, 2], [0, 1, 3, 77], [1, 0, 4, 11]]
    cs = np.zeros((W, B * T), np.int32)
    cn = np.zeros((W, B * T), np.int32)
    cids = np.full(B * T, -1, np.int32)
    for b, row in enumerate(terms):
        c_s, c_n = compute_cells(seg, [seg.term_id(f"t{i}") for i in row])
        cs[:, b * T : (b + 1) * T] = c_s
        cn[:, b * T : (b + 1) * T] = c_n
        cids[b * T : b * T + 2] = [row[0], row[1]]  # hot ids 0 / 1
    cn = cn * (cids[None, :] < 0)
    deleted = np.zeros((W, 128, 128), np.float32)
    deleted.reshape(-1)[rng.choice(seg.n_docs, 3000, replace=False)] = 1.0
    return dict(
        seg=seg, W=W, B=B, T=T, bmeta=bmeta, planes=planes, cs=cs, cn=cn,
        cids=cids, tf_planes=np.ascontiguousarray(tf_planes.numpy()),
        deleted=deleted,
        weights=rng.uniform(0.5, 4.0, size=(B, T)).astype(np.float32),
    )


def _torch(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _compare(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)
    assert np.isfinite(np.asarray(want[0])).any()


def flat_batch(seg, terms, cached, flags, kmin, seed):
    """Flat-kernel inputs for one query row per entry of `terms` (term
    names, "" for a padding slot): cell tables, per-slot weights, and cids
    where `cached` maps a term to its hot-plane id (those slots decode
    nothing). Returns (cs, cn, weights, flags, kmin, cids)."""
    B, T = len(terms), len(terms[0])
    W = seg.n_windows
    cs = np.zeros((W, B * T), np.int32)
    cn = np.zeros((W, B * T), np.int32)
    cids = np.full(B * T, -1, np.int32)
    for b, row in enumerate(terms):
        tids = [seg.term_id(t) if t else -1 for t in row]
        c_s, c_n = compute_cells(seg, tids)
        cs[:, b * T : (b + 1) * T] = c_s
        cn[:, b * T : (b + 1) * T] = c_n
        cids[b * T : (b + 1) * T] = [cached.get(t, -1) for t in row]
    cn = cn * (cids[None, :] < 0)
    weights = np.random.default_rng(seed).uniform(0.5, 4.0, size=(B, T))
    return (cs, cn, weights.astype(np.float32), np.asarray(flags, np.int32),
            np.asarray(kmin, np.int32), cids)


# flat batches at the kernel's stress shapes (flags 1 = required, 2 =
# negated, 4 = optional; kmin T + 1 on a padding row). t0 and t1 are the
# fixture's hot planes 0 and 1.
FLAT_SHAPES = {
    # one cached plane in every query, beside decoded and padding slots
    "shared-plane": (
        [["t0", "t5"], ["t0", "t9"], ["t0", "t30"], ["t0", ""]],
        {"t0": 0}, [[1, 1], [1, 4], [1, 2], [1, 0]], [2, 1, 1, 1]),
    # eight decoded dense terms (cells that cross every chunk boundary):
    # 3-of-8, a mix with negated and optional members, a padding row
    "t8-decoded": (
        [[f"t{i}" for i in range(8)], [f"t{i}" for i in range(2, 10)],
         [""] * 8],
        {}, [[1] * 8, [1, 1, 2, 4, 4, 1, 2, 4], [0] * 8], [3, 2, 9]),
    "t1": ([["t1"], ["t3"], [""]], {"t1": 1}, [[1], [1], [0]], [1, 1, 2]),
    "t2": ([["t1", "t4"], ["t6", "t0"], ["t2", "t7"], ["", ""]],
           {"t0": 0, "t1": 1}, [[1, 1], [1, 2], [1, 1], [0, 0]],
           [2, 1, 1, 3]),
}


def _flat_args(d, shape):
    """(args before n_docs, B, T) of a flat call: the fixture's mixed
    batch (rows: AND + NOT, OR with an optional member, 2-of-4, padded
    row) or one of FLAT_SHAPES."""
    if shape == "mixed":
        flags = np.array([[1, 1, 2, 0], [1, 4, 1, 0], [1, 1, 1, 1],
                          [0, 0, 0, 0]], np.int32)
        kmin = np.array([2, 1, 2, d["T"] + 1], np.int32)
        names = ("bmeta", "planes", "cs", "cn", "weights")
        args = [d[n] for n in names] + [flags, kmin, d["cids"],
                                        d["tf_planes"]]
        return args, d["B"], d["T"]
    terms, cached, flags, kmin = FLAT_SHAPES[shape]
    cs, cn, w, fl, km, cids = flat_batch(d["seg"], terms, cached, flags,
                                         kmin, seed=len(shape))
    args = [d["bmeta"], d["planes"], cs, cn, w, fl, km, cids, d["tf_planes"]]
    return args, len(terms), len(terms[0])


@pytest.mark.parametrize("scorer,shape", [
    ("bm25", "mixed"), ("tfidf", "mixed"), ("trivial", "mixed"),
    ("bm25", "shared-plane"), ("tfidf", "t8-decoded"), ("trivial", "t1"),
    ("bm25", "t2"),
], ids=["bm25", "tfidf", "trivial", "shared-plane", "t8-decoded", "t1", "t2"])
def test_flat_ref_equals_jax(inputs, scorer, shape):
    """The flat kernel's plain version against the JAX kernel in interpret
    mode, with deletions and the last window cut by n_docs mid-chunk; the
    padding rows come out all -inf."""
    d = inputs
    args, B, T = _flat_args(d, shape)
    want = ref.fused_flat_score_tiles(
        *map(jnp.asarray, args), d["seg"].n_docs, jnp.asarray(d["deleted"]),
        scorer_name=scorer, n_windows=d["W"], n_terms=T, batch=B,
        interpret=True,
    )
    got = port.fused_flat_score_tiles(
        *map(_torch, args), d["seg"].n_docs, _torch(d["deleted"]),
        scorer_name=scorer,
    )
    _compare(got, want)
    kmin = args[6]
    for b in np.flatnonzero(kmin > T):
        assert np.isneginf(got[0][b].numpy()).all()  # padded row


TAPES = [
    # OR-of-AND (the bench's nested family)
    ("or", ("and", ("tok", 0, 0), ("tok", 1, 1)),
     ("and", ("tok", 2, 2), ("tok", 3, 3))),
    # slot reuse, optional, k-of-n, unary NOT
    ("or", ("and", ("tok", 0, 0), ("opt", ("tok", 1, 1))),
     ("not", ("some", 2, (("tok", 2, 2), ("tok", 3, 3), ("tok", 1, 1))),
      ("unot", ("unot", ("tok", 0, 0))))),
]


@pytest.mark.parametrize("scorer,tape", [("bm25", TAPES[0]),
                                         ("tfidf", TAPES[1])])
def test_tape_ref_equals_jax(inputs, scorer, tape):
    d = inputs
    args = [d[n] for n in ("bmeta", "planes", "cs", "cn", "weights",
                           "cids", "tf_planes")]
    want = ref.fused_score_tiles(
        *map(jnp.asarray, args), d["seg"].n_docs, jnp.asarray(d["deleted"]),
        tape=tape, scorer_name=scorer, n_windows=d["W"], n_terms=d["T"],
        batch=d["B"], interpret=True,
    )
    got = port.fused_score_tiles(
        *map(_torch, args), d["seg"].n_docs, _torch(d["deleted"]),
        tape=tape, scorer_name=scorer,
    )
    _compare(got, want)


def test_tfidf_sqrt_is_ieee():
    """The plain versions' TF-IDF sqrt is correctly rounded, like the
    oracle's np.sqrt and the kernels' __fsqrt_rn (torch's CPU sqrt is not)."""
    x = np.concatenate([
        np.arange(0, 1 << 18, dtype=np.float32),
        np.random.default_rng(5).uniform(0, 1e7, 1 << 18).astype(np.float32),
    ])
    got = port_sim.ieee_sqrt(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(x))


def test_encode_tape_postfix():
    """The tape kernel's register program: each node evaluated into a
    register with those above it free (binary ops combine r and r + 1),
    k-of-n folded child by child (SACC) and closed by SFIN."""
    prog, nreg = port.encode_tape(TAPES[1], port.tape_used_slots(TAPES[1]))
    assert prog.shape == (15, 4) and nreg == 3
    assert [tuple(int(x) for x in r[:2]) for r in prog] == [
        (port.OP_TOK, 0), (port.OP_TOK, 1), (port.OP_OPT, 1),
        (port.OP_AND, 0), (port.OP_TOK, 1), (port.OP_TOK, 2),
        (port.OP_SACC, 1), (port.OP_TOK, 2), (port.OP_SACC, 1),
        (port.OP_SFIN, 1), (port.OP_TOK, 2), (port.OP_UNOT, 2),
        (port.OP_UNOT, 2), (port.OP_NOT, 1), (port.OP_OR, 0)]
    assert list(prog[9]) == [port.OP_SFIN, 1, 2, 0]
    assert list(prog[7]) == [port.OP_TOK, 2, 1, 1]  # slot 1 reused: tile 1
    with pytest.raises(ValueError):
        port.encode_tape(("phrase", (0, 1), 0), (0, 1))
    deep = ("tok", 0, 0)
    for _ in range(16):
        deep = ("or", ("tok", 0, 0), deep)
    with pytest.raises(ValueError):
        port.encode_tape(deep, (0,))  # 17 registers


PROGRAM_TAPES = {
    "or-of-and": TAPES[0],
    "k-of-n": ("some", 2, (("tok", 0, 0), ("tok", 1, 1), ("tok", 2, 2),
                           ("tok", 3, 3))),
    "not": ("not", ("or", ("tok", 0, 0), ("tok", 1, 1)),
            ("and", ("tok", 2, 2), ("tok", 3, 3))),
    "optional": ("and", ("tok", 0, 0), ("and", ("opt", ("tok", 1, 1)),
                                        ("opt", ("tok", 2, 2)))),
    "slot-reuse": TAPES[1],
}


@pytest.mark.parametrize("name", sorted(PROGRAM_TAPES))
def test_register_program_equals_tape_ref(inputs, name):
    """The register program, run by eval_program over the staged tiles,
    equals fused_score_tiles_ref bit for bit (masks and f32 scores)."""
    d = inputs
    tape = PROGRAM_TAPES[name]
    args = [_torch(d[n]) for n in ("bmeta", "planes", "cs", "cn", "weights",
                                   "cids", "tf_planes")]
    want, _ = port.fused_score_tiles_ref(
        *args, d["seg"].n_docs, _torch(d["deleted"]), tape=tape,
        scorer_name="bm25")
    bmeta, planes, cs, cn, weights, cids, tf_planes = args
    B, T, W = d["B"], d["T"], d["W"]
    tiles = port._slot_tiles(bmeta, planes, cs, cn, cids, tf_planes)
    tiles = tiles.reshape(W, B, T, 128, 128).transpose(0, 1)
    used = port.tape_used_slots(tape)
    prog, _ = port.encode_tape(tape, used)
    mask, score = port.eval_program(
        prog, {u: tiles[:, :, s] for u, s in enumerate(used)},
        lambda i: weights[:, i].reshape(B, 1, 1, 1), "bm25")
    got, _ = port._epilogue(mask, score, d["seg"].n_docs, _torch(d["deleted"]))
    assert torch.equal(got, want)
    assert torch.isfinite(want).any()


def test_score_bytes_by_hand():
    """score_bytes on a hand-made bmeta: one query row, two slots; slot 0
    decodes blocks 0-1 in window 0 and block 1 again in window 1 (a
    boundary block: counted once), slot 1 is cached (one plane tile a
    window). With zero planes every posting of a block sits on its first
    doc: block 0 holds 3 postings of doc 5, block 1 2 of doc 0, so window
    0 scores 5 postings and window 1 none (doc 0 lies outside it)."""
    bmeta = torch.zeros((2, 128), dtype=torch.int32)
    meta = bmeta.reshape(-1, 8)
    meta[0, [C_BD, C_BF, C_FIRST, C_COUNT]] = torch.tensor(
        [5, 3, 5, 3], dtype=torch.int32)
    meta[1, [C_BD, C_BF, C_FIRST, C_COUNT]] = torch.tensor(
        [7, 1, 0, 2], dtype=torch.int32)
    planes = torch.zeros((16, 128), dtype=torch.int32)
    cs = torch.tensor([[0, 0], [1, 0]], dtype=torch.int32)
    cn = torch.tensor([[2, 0], [1, 0]], dtype=torch.int32)
    cids = torch.tensor([-1, 0], dtype=torch.int32)
    deleted = torch.zeros((2, 128, 128))
    nbytes, ops = port.score_bytes(bmeta, planes, cs, cn, cids, 1, deleted, 2)
    out = 1 * 2 * (16384 + 16 * 128) * 4  # scores + sub-block maxima
    tables = 2 * 4 * 4 + 2 * 4 + 1 * 2 * 4  # cell tables, cids, weights
    blocks = 2 * 32 + 128 * (5 + 3 + 7 + 1) // 8  # rows + plane bits
    hot = 1 * 2 * 16384 * 4  # one cached term, two windows
    assert nbytes == out + tables + blocks + hot + 2 * 16384 * 4
    assert ops == 4 * 5


def _tie_heavy(rng, B, W):
    """Scores from a 3-value set with -inf holes; row 1 is one constant,
    row 2 has fewer matches than k."""
    vals = np.array([0.5, 1.0, 2.0], np.float32)
    s = vals[rng.integers(0, 3, size=(B, W, 128, 128))]
    s[rng.random(s.shape) < 0.4] = -np.inf
    s[1] = np.where(np.isinf(s[1]), s[1], 2.0)
    s[2] = -np.inf
    s[2].reshape(-1)[rng.choice(W * 16384, 5, replace=False)] = 1.0
    sb = s.reshape(B, W, 16, 8, 128).max(axis=3).max(axis=-1, keepdims=True)
    return s, np.ascontiguousarray(np.broadcast_to(sb, (B, W, 16, 128)))


@pytest.mark.parametrize("W,k", [(3, 10), (3, 40), (1, 10)])
def test_exact_window_topk_ties(W, k):
    rng = np.random.default_rng(W * 100 + k)
    scores, rmax = _tie_heavy(rng, 3, W)
    wv, wi = ref.exact_window_topk(jnp.asarray(scores), jnp.asarray(rmax), k)
    gv, gi = port.exact_window_topk(torch.from_numpy(scores),
                                    torch.from_numpy(rmax), k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
