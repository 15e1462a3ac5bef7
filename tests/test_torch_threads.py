"""First-use builds under threads, and the 2^24-doc guard, on the port.

- N threads at the first search of a CPU executor build each hot-term
  cache (the frequency planes and the posmask cache) once, and every
  thread's results equal a serial executor's.
- N threads at the first ``kernels.load()`` build and bind the kernel
  library once (``kernels.build`` and the ctypes loader replaced by
  counting fakes: this host has no nvcc).
- The seal's miss counter stays exact when many threads record new
  variants at once.
- ``Executor`` raises ValueError ("2^24") on a 2^24-doc segment (twin of
  tests/test_limits_guard.py::test_executor_rejects_2_24_docs).
"""

import dataclasses
import sys
import threading
import time
import types

import numpy as np
import pytest

from torch_twins import build_pair, reconfigured
from trinity_tpu.exec import Executor as JaxExecutor
from trinity_tpu.limits import MAX_SEGMENT_DOCS as JAX_MAX_SEGMENT_DOCS
from trinity_tpu_torch import Executor
from trinity_tpu_torch.limits import MAX_SEGMENT_DOCS
from trinity_tpu_torch.utils import kernels, seal

N_THREADS = 16


def _fill(sess):
    rng = np.random.default_rng(5)
    zipf = 1.0 / np.arange(1, 31)
    for d in range(600):
        toks = [f"t{int(i)}" for i in rng.choice(
            30, size=int(rng.integers(5, 30)), p=zipf / zipf.sum())]
        p = sess.begin(d)
        for pos, t in enumerate(toks, start=1):
            p.insert(t, pos)
        sess.insert(p)


QUERIES = ["t0 t1", '"t0 t1"', "t2 OR t3", '"t1 t0"']


def run_threads(n, target):
    """Start `n` threads together on target(i); join each with a timeout;
    returns their results (re-raises a thread's exception)."""
    barrier = threading.Barrier(n)
    out, errs = [None] * n, []

    def run(i):
        try:
            barrier.wait(timeout=30)
            out[i] = target(i)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    if errs:
        raise errs[0]
    return out


def _counting(ex, name, counts):
    build = getattr(ex, name)

    def counted():
        counts[name] = counts.get(name, 0) + 1
        time.sleep(0.05)  # widen the window in which another thread races
        return build()

    setattr(ex, name, counted)


def test_first_searches_build_each_cache_once():
    seg, _ = build_pair(_fill)
    with reconfigured(hot_cache_min_df=10, posmask_min_df=10):
        ex = Executor(seg, "cpu")
        want = Executor(seg, "cpu").search_batch(QUERIES, k=10)
    assert ex._hot and ex._pos_hot  # both caches have terms to build
    counts = {}
    for name in ("_build_tf_planes", "_build_pos_planes"):
        _counting(ex, name, counts)
    got = run_threads(N_THREADS,
                      lambda i: ex.search(QUERIES[i % len(QUERIES)], k=10))
    assert counts == {"_build_tf_planes": 1, "_build_pos_planes": 1}
    for i, res in enumerate(got):
        assert res == want[i % len(QUERIES)]


def test_threaded_warmup_equals_serial():
    """warmup(threads=8) on a fresh executor builds each cache once and
    leaves search results as a serial executor's."""
    seg, _ = build_pair(_fill)
    with reconfigured(hot_cache_min_df=10, posmask_min_df=10):
        ex = Executor(seg, "cpu")
        serial = Executor(seg, "cpu")
    counts = {}
    for name in ("_build_tf_planes", "_build_pos_planes"):
        _counting(ex, name, counts)
    w = ex.warmup(QUERIES * 4, k=10, threads=8)
    assert counts == {"_build_tf_planes": 1, "_build_pos_planes": 1}
    assert w["variants"] == 4 * len(QUERIES) + 1
    assert ex.search_batch(QUERIES) == serial.search_batch(QUERIES)


def test_concurrent_load_builds_the_library_once(monkeypatch):
    builds, opens = [], []

    def fake_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)
        return "/nonexistent/libtrinity_kernels-fake.so"

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    def fake_cdll(path):
        opens.append(path)
        return FakeLib()

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "build", fake_build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", fake_cdll)
    libs = run_threads(N_THREADS, lambda i: kernels.load())
    assert len(builds) == 1 and len(opens) == 1
    assert all(lib is libs[0] for lib in libs)
    assert libs[0].trin_decode_tiles.restype is kernels.ctypes.c_int


def test_seal_counts_every_miss_under_threads():
    before = seal.post_seal_misses()
    seal.seal_programs(strict=False)
    try:
        run_threads(N_THREADS, lambda i: [
            seal.record(("threads-test", i, j)) for j in range(50)])
    finally:
        seal.unseal_programs()
    assert seal.post_seal_misses() - before == N_THREADS * 50


def _tiny_pair():
    def fill(sess):
        p = sess.begin(1)
        p.insert("a", 1)
        sess.insert(p)
    return build_pair(fill)


def test_executor_rejects_2_24_docs():
    seg, ref = _tiny_pair()
    assert MAX_SEGMENT_DOCS == JAX_MAX_SEGMENT_DOCS == 1 << 24
    big = dataclasses.replace(seg, doc_map=np.zeros(MAX_SEGMENT_DOCS,
                                                    np.uint32))
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="2\\^24"):
            Executor(big, device)
    with pytest.raises(ValueError, match="2\\^24"):
        JaxExecutor(dataclasses.replace(
            ref, doc_map=np.zeros(MAX_SEGMENT_DOCS, np.uint32)))
    # one below the limit passes the guard
    ok = dataclasses.replace(seg, doc_map=np.zeros(MAX_SEGMENT_DOCS - 1,
                                                   np.uint32))
    assert Executor(ok, "cpu").seg.n_docs == MAX_SEGMENT_DOCS - 1
