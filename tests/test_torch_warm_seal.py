"""Twin of tests/test_warm_seal.py: warmup coverage and the seal
(utils/seal.py) on the port's CPU executor. After warming a workload and
sealing, serving the same workload records no new variant; a novel launch
shape is detected (counted, and raised in strict mode). Beyond the
original: warmup's return value, and a collection warmed through the same
driver."""

import numpy as np
import pytest

from torch_twins import build_pair
from trinity_tpu_torch import Executor, IndexSourcesCollection
from trinity_tpu_torch.utils.seal import (
    post_seal_misses,
    seal_programs,
    unseal_programs,
)


def _fill(sess):
    rng = np.random.default_rng(11)
    for d in range(400):
        toks = [f"t{int(i)}" for i in rng.integers(0, 60, rng.integers(4, 24))]
        sess.bulk_index([d], [toks])


@pytest.fixture(scope="module")
def seg():
    return build_pair(_fill)[0]


@pytest.fixture(scope="module")
def ex(seg):
    return Executor(seg, "cpu")


WORKLOAD = [
    "t0 t1",
    "t2 OR t3 OR t4",
    "t5 NOT t6",
    '"t0 t1"',
]


@pytest.fixture(autouse=True)
def _unseal():
    yield
    unseal_programs()


def test_sealed_serving_dispatches_no_new_variant(ex):
    w = ex.warmup(WORKLOAD, k=10)
    assert set(w) == {"programs", "variants", "seconds"}
    assert w["variants"] == len(WORKLOAD) + 1 and w["programs"] > 0
    before = post_seal_misses()
    seal_programs(strict=True)  # strict: a miss raises, not just counts
    # the serving loop: batched (pipelined) and single-stream, same queries
    h = ex.launch_batch(WORKLOAD, k=10)
    ex.finish_batch(h)
    for q in WORKLOAD:
        ex.search(q, k=10)
    assert post_seal_misses() == before
    # warming again records nothing new
    unseal_programs()
    assert ex.warmup(WORKLOAD, k=10, threads=1)["programs"] == 0


def test_post_seal_novel_shape_is_detected(ex):
    ex.warmup(WORKLOAD, k=10)
    seal_programs(strict=False)
    before = post_seal_misses()
    # a T-bucket the warmup never touched (many-term disjunction)
    novel = " OR ".join(f"t{i}" for i in range(11))
    ex.search(novel, k=10)
    assert post_seal_misses() > before


def test_post_seal_strict_raises(ex):
    ex.warmup(WORKLOAD, k=10)
    seal_programs(strict=True)
    novel = " ".join(f"t{i}" for i in range(9, 20))
    with pytest.raises(RuntimeError, match="warmup coverage hole"):
        ex.search(novel, k=10)


def test_collection_warmup_then_seal(seg):
    """A collection warms through the same driver: after it, serving the
    workload records nothing new, and a new executor's hot-cache build is
    a miss."""
    coll = IndexSourcesCollection(device="cpu").add_segment(seg, 1)
    w = coll.warmup(WORKLOAD, k=10, threads=4)
    assert w["variants"] == len(WORKLOAD) + 1
    seal_programs(strict=True)
    before = post_seal_misses()
    coll.search_batch(WORKLOAD, k=10)
    assert post_seal_misses() == before
    with pytest.raises(RuntimeError, match="warmup coverage hole"):
        Executor(seg, "cpu").search("t0 t1", k=10)
