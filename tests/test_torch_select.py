"""Twin of tests/test_select.py: the port's bound_select_candidates
(trinity_tpu_torch/ops/select.py, torch on the CPU) must equal lax.top_k's
(bound desc, docid asc) selection exactly — set, ordering, tau and
overflow — on the original's tie-heavy integer bound distributions, and
equal the JAX package's bound_select_candidates output for output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trinity_tpu.ops.select import (
    bound_select_candidates as jax_bound_select_candidates,
)
from trinity_tpu_torch.ops.select import bound_select_candidates


def select(b, C2, vmax):
    """The port's selection on a numpy bound matrix, as numpy."""
    return tuple(x.numpy() for x in bound_select_candidates(
        torch.from_numpy(b), C2, vmax))


@pytest.mark.parametrize("vmax", [1, 3, 8, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_topk(vmax, seed):
    rng = np.random.default_rng(seed)
    B, N, C2 = 3, 5000, 64
    b = np.zeros((B, N), np.int32)
    for i in range(B):
        ncand = int(rng.integers(0, N))
        idx = rng.choice(N, ncand, replace=False)
        b[i, idx] = np.minimum(rng.geometric(0.6, ncand), vmax)
    ki, valid, tau, ov = select(b, C2, vmax)
    kb, kiref = map(np.asarray, jax.lax.top_k(jnp.asarray(b), C2))
    for i in range(B):
        want = set(kiref[i][kb[i] > 0].tolist())
        got = ki[i][valid[i]].tolist()
        assert sorted(got) == got  # docid ascending
        assert set(got) == want
        nv = int((b[i] > 0).sum())
        assert bool(ov[i]) == (nv > C2)
        if ov[i]:
            unpulled = np.ones(N, bool)
            unpulled[got] = False
            assert tau[i] == b[i][unpulled].max()
            assert tau[i] <= kb[i, -1]
    jki, jvalid, jtau, jov = map(np.asarray, jax_bound_select_candidates(
        jnp.asarray(b), C2, vmax))
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(np.where(valid, ki, 0),
                                  np.where(jvalid, jki, 0))
    np.testing.assert_array_equal(tau, jtau)
    np.testing.assert_array_equal(ov, jov)


def test_all_zero_and_full():
    B, N, C2 = 2, 1000, 16
    ki, valid, tau, ov = select(np.zeros((B, N), np.int32), C2, 8)
    assert not valid.any() and not ov.any()
    ki, valid, tau, ov = select(np.ones((B, N), np.int32), C2, 8)
    assert valid.all() and ov.all()
    # overflow at uniform bound: first C2 docids win (docid tie-break)
    assert np.array_equal(ki[0], np.arange(C2))
    assert tau.tolist() == [1, 1]


def test_assume_no_overflow_is_a_compaction():
    """With the caller's proof of no overflow, the selection is the
    docid-order compaction of bound > 0 and tau is 0."""
    rng = np.random.default_rng(2)
    b = (rng.random((2, 300)) < 0.1).astype(np.int32) * 3
    ki, valid, tau, ov = (x.numpy() for x in bound_select_candidates(
        torch.from_numpy(b), 64, 3, assume_no_overflow=True))
    for i in range(2):
        assert ki[i][valid[i]].tolist() == np.flatnonzero(b[i]).tolist()
    assert not tau.any() and not ov.any()
