"""Port decode (trinity_tpu_torch/ops/postings.py) against the JAX package.

- The port's copies of pack_block_meta, pad_planes, compute_cells and the
  layout constants equal the originals in trinity_tpu/ops/postings.py.
- materialize_freq_tiles_ref (the plain torch version of the CUDA decode
  kernel) equals the JAX materialize_freq_tiles, run in interpret mode as
  the JAX package's own tests run it on the CPU, with and without hit
  offsets, on a 3-window segment with freqs above 255 and wide bit widths,
  and on blocks built by hand (tests/torch_blocks.py).
  Freq and offset tiles are integers: they must match exactly.
- On CPU tensors the wrapper runs that plain version.
- decode_bytes and block_bytes give the byte counts worked out by hand.
The segment is built by both packages' builders (held equal); the port's
functions read the port's segment and the reference's the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trinity_tpu.ops.postings as ref
import trinity_tpu_torch.ops.postings as port
from torch_blocks import wide_blocks
from torch_twins import bulk_pair


def make_segment(seed=3, n_docs=36_000, vocab=300):
    """Zipf corpus over 3 windows, plus docs with freqs above 255 (wide
    freq fields) and a sparse term (wide doc-delta fields)."""
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, vocab + 1) ** 1.1
    zipf /= zipf.sum()
    docs = [list(rng.choice(vocab, size=int(rng.integers(3, 10)), p=zipf))
            for _ in range(n_docs)]
    for d in rng.choice(n_docs, size=30, replace=False):
        docs[d] += [vocab] * int(rng.integers(256, 4000))
    for d in range(0, n_docs, 6007):
        docs[d].append(vocab + 1)
    bounds = np.zeros(n_docs + 1, np.int64)
    np.cumsum([len(d) for d in docs], out=bounds[1:])
    return bulk_pair(np.arange(n_docs) * 2, np.concatenate(docs), bounds,
                     [f"t{i}" for i in range(vocab + 2)])


@pytest.fixture(scope="module")
def segs():
    return make_segment()


@pytest.fixture(scope="module")
def seg(segs):
    return segs[0]


def _term_ids(seg):
    # hot, heavy-freq, sparse, unknown, a rare term, mid terms
    return [seg.term_id(t) for t in ("t0", "t300", "t301")] + [
        -1, seg.term_id("t250"), seg.term_id("t9"), seg.term_id("t1"),
        seg.term_id("t40"),
    ]


def test_constants_equal_reference():
    names = ["MAXB", "MAXROWS", "META_COLS", "META_PER_ROW", "META_ROWS"]
    names += [n for n in dir(ref) if n.startswith("C_")]
    for n in names:
        assert getattr(port, n) == getattr(ref, n), n


def test_host_helpers_equal_reference(segs):
    seg, ref_seg = segs
    np.testing.assert_array_equal(port.pack_block_meta(seg),
                                  ref.pack_block_meta(ref_seg))
    a, b = port.pad_planes(seg.planes), ref.pad_planes(ref_seg.planes)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    tids = _term_ids(seg)
    assert tids == _term_ids(ref_seg)
    for got, want in zip(port.compute_cells(seg, tids),
                         ref.compute_cells(ref_seg, tids)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case,with_offsets", [
    ("all", False), ("all", True), ("subset", False), ("subset", True),
    ("empty-cells", True), ("out-view", False), ("wide-blocks", False),
    ("wide-blocks", True),
], ids=["False", "True", "subset", "subset-offsets", "empty-cells",
        "out-view", "wide-blocks", "wide-blocks-offsets"])
def test_decode_ref_equals_jax(seg, case, with_offsets):
    """The decode kernel's plain version against the JAX kernel in
    interpret mode: every window; a gathered subset of windows in another
    order (window_base [2, 0]); cells emptied beside the unknown term's;
    the freq tiles written into a strided view of a larger cache; 40
    partial blocks with wide fields in one 2048-doc range (torch_blocks)."""
    if case == "wide-blocks":
        bmeta, planes, cs, cn = wide_blocks()
        assert cn[0, 0] > 40
    else:
        bmeta = port.pack_block_meta(seg)
        planes = port.pad_planes(seg.planes)
        cs, cn = port.compute_cells(seg, _term_ids(seg))
        assert cs.shape[0] == 3 and seg.block_bits_freq.max() >= 9
    base = None
    if case == "subset":
        base = np.array([2, 0], np.int32)
        cs, cn = cs[base], cn[base]
    if case == "empty-cells":
        cn[1, :] = 0
        cn[:, 4] = 0
    W, T = cs.shape
    want = ref.materialize_freq_tiles(
        jnp.asarray(bmeta), jnp.asarray(planes), jnp.asarray(cs),
        jnp.asarray(cn), None if base is None else jnp.asarray(base),
        n_windows=W, n_terms=T, interpret=True, with_offsets=with_offsets,
    )
    out = cache = None
    if case == "out-view":
        cache = torch.full((T + 2, W, 128, 128), 7.0)
        out = cache[1 : T + 1].transpose(0, 1)
    got = port.materialize_freq_tiles(
        torch.from_numpy(bmeta), torch.from_numpy(planes.view(np.int32)),
        torch.from_numpy(cs), torch.from_numpy(cn),
        None if base is None else torch.from_numpy(base),
        with_offsets=with_offsets, out=out,
    )
    if not with_offsets:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == {np.dtype("float32"): torch.float32,
                           np.dtype("int32"): torch.int32}[w.dtype]
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0].max() > 255
    if cache is not None:
        assert got[0].data_ptr() == out.data_ptr()
        assert (cache[0] == 7).all() and (cache[-1] == 7).all()


def test_decode_window_base_subset(seg):
    """A gathered subset of windows (window_base) equals those windows of
    the full decode."""
    bmeta = torch.from_numpy(port.pack_block_meta(seg))
    planes = torch.from_numpy(port.pad_planes(seg.planes).view(np.int32))
    cs, cn = (torch.from_numpy(a)
              for a in port.compute_cells(seg, _term_ids(seg)))
    full, foff = port.materialize_freq_tiles_ref(bmeta, planes, cs, cn,
                                                 with_offsets=True)
    sel = torch.tensor([2, 0], dtype=torch.int32)
    sub, soff = port.materialize_freq_tiles_ref(
        bmeta, planes, cs[sel.long()], cn[sel.long()], window_base=sel,
        with_offsets=True,
    )
    assert torch.equal(sub, full[sel.long()])
    assert torch.equal(soff, foff[sel.long()])
