"""The port's residency manager: lazy upload, LRU eviction under a byte
budget, re-upload (twin of tests/test_residency.py, on CPU executors).

Executors keep their packed host forms and upload their segment arrays
through ``ResidencyManager.ensure`` at first use; ``evict()`` drops them and
the next search uploads them again with unchanged results; a budget that
fits about one segment evicts the least recently used ones; an unlimited
budget never evicts; two threads searching two executors under a
one-segment budget always read a whole array dict. Beyond the twin: the
budget counts executors per device, an erase-only (0-doc) executor uploads
nothing when a collection commits, and the counters move as the reference's
do.
"""

import threading

import numpy as np
import pytest

from trinity_tpu_torch import (
    Executor,
    IndexSourcesCollection,
    SegmentIndexSession,
    configure,
    get_config,
)
from trinity_tpu_torch.exec.residency import get_residency


def _seg(seed, n_docs=600, vocab=30):
    rng = np.random.default_rng(seed)
    sess = SegmentIndexSession()
    ids = list(range(n_docs))
    docs = [[f"r{int(x)}" for x in rng.integers(0, vocab, 6)] for _ in ids]
    sess.bulk_index(ids, docs)
    return sess.commit()


def _ex(seed):
    return Executor(_seg(seed), device="cpu")


def _pairs(res):
    return [(r.doc_id, r.score) for r in res]


@pytest.fixture
def budget():
    old = get_config().hbm_budget_bytes
    yield
    configure(hbm_budget_bytes=old)


def test_lazy_upload_and_reupload(budget):
    mgr = get_residency()
    ex = _ex(1)
    assert ex._dev is None, "upload must be lazy"
    up0 = mgr.uploads
    r1 = ex.search("r0 r1", k=5)
    assert ex._dev is not None and mgr.uploads == up0 + 1
    assert ex.device_bytes == sum(t.numel() * t.element_size()
                                  for t in ex._dev.values())
    ex.evict()
    assert ex._dev is None
    r2 = ex.search("r0 r1", k=5)  # uploads again
    assert mgr.uploads == up0 + 2
    assert _pairs(r1) == _pairs(r2) and r1


def test_budget_evicts_lru(budget):
    exs = [_ex(s) for s in range(4)]
    # a budget of about one segment: each search evicts the others
    configure(hbm_budget_bytes=int(max(e.device_bytes for e in exs) * 1.5))
    mgr = get_residency()
    ev0 = mgr.evictions
    expected = [e.search("r0 OR r2", k=5) for e in exs]
    assert mgr.evictions > ev0, "the budget should have forced evictions"
    assert sum(1 for e in exs if e._dev is not None) <= 2
    for e, want in zip(exs, expected):  # unchanged when cycled back in
        assert _pairs(e.search("r0 OR r2", k=5)) == _pairs(want)
    assert mgr.resident_bytes() <= get_config().hbm_budget_bytes


def test_unlimited_budget_never_evicts(budget):
    configure(hbm_budget_bytes=0)
    mgr = get_residency()
    ev0 = mgr.evictions
    exs = [_ex(10 + s) for s in range(3)]
    for e in exs:
        e.search("r1", k=3)
    assert all(e._dev is not None for e in exs)
    assert mgr.evictions == ev0


def test_concurrent_eviction_race(budget):
    """Readers take the arrays from the dict ensure() returns: another
    thread's ensure() may evict this executor as soon as it returns."""
    ex1, ex2 = _ex(3), _ex(4)
    configure(hbm_budget_bytes=max(ex1.device_bytes, ex2.device_bytes) + 1024)
    want1 = _pairs(ex1.search("r0 r1", k=5))
    want2 = _pairs(ex2.search("r0 r1", k=5))
    errors = []

    def hammer(ex, want):
        try:
            for _ in range(8):
                assert _pairs(ex.search("r0 r1", k=5)) == want
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(ex1, want1)),
               threading.Thread(target=hammer, args=(ex2, want2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert get_residency().evictions > 0  # the budget really thrashed


def test_budget_is_per_device(budget, monkeypatch):
    """Executors on another device neither count against a device's
    budget nor are evicted for it."""
    a, b = _ex(20), _ex(21)
    a.search("r0", k=3)
    configure(hbm_budget_bytes=b.device_bytes + 1024)
    monkeypatch.setattr(a, "device", "elsewhere")  # as if on another card
    b.search("r0", k=3)
    assert a._dev is not None and b._dev is not None
    assert get_residency().resident_bytes(b.device) == b.device_bytes


def test_erase_only_source_uploads_nothing(budget):
    """commit() builds an executor for every source, the erase-only one
    included; its first use is a search of the collection, which skips a
    0-doc source, so it never uploads."""
    up0 = get_residency().uploads
    sess = SegmentIndexSession()
    sess.erase(3)
    c = IndexSourcesCollection(device="cpu").add_segment(_seg(30), 1)
    c.add_segment(sess.commit(), 2).commit()
    hits = c.search("r0 OR r1", k=600)
    assert hits and 3 not in {r.doc_id for r in hits}
    empty = c.sources[0].executor()
    assert empty.seg.n_docs == 0 and empty._dev is None
    assert get_residency().uploads == up0 + 1
