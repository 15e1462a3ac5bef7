"""The port's tracer (utils/timings.py) and the spans at its layer boundaries.

On small segments built by the port's own builder, with executors and a
collection on ``device="cpu"``:

- a mixed batch (flat boolean, posmask phrase, lazy phrase) records
  ``exec.launch`` around ``exec.prepare``, one ``exec.group.<kind>`` a
  group and ``exec.phrase`` in the phrase groups, then ``exec.finish``
  around ``exec.device``; every interval lies inside its parent's, and two
  batches launched before either is finished keep their own ids;
- a three-source collection (one source holds only erasures) records
  ``collection.launch`` with one ``exec.launch`` a live source, and
  ``collection.finish`` around the sources' ``exec.finish`` and
  ``collection.merge``;
- with recording off nothing is kept and the totals still count; the cap
  drops spans and counts them; 16 threads give exact totals; a garbage
  collection is a ``host.gc`` span of the process's tracer alone; ``plan.df_lookups`` counts the plan's
  ``df_of`` calls;
- the tracer keeps the reference's interface (``trace``, ``add``,
  ``snapshot``'s keys, ``reset``, ``get_tracer``).
"""

import gc
import sys
import threading
import time
from collections import defaultdict

import numpy as np
import pytest

from trinity_tpu_torch import (
    Executor,
    IndexSourcesCollection,
    SegmentIndexSession,
)
from trinity_tpu_torch.utils import timings
from trinity_tpu_torch.utils.timings import Tracer, get_tracer

BOOLEAN = ["t0 t1", "t3 OR t4", "t2 NOT t0"]
BIGRAM, TRIGRAM = '"t0 t1"', '"t5 t6 t7"'


def _segment(docs, erase=(), update=None):
    sess = SegmentIndexSession()
    for d, toks in docs.items():
        p = sess.begin(d)
        for pos, t in enumerate(toks, start=1):
            p.insert(t, pos)
        sess.insert(p)
    for d, toks in (update or {}).items():
        p = sess.begin(d)
        for pos, t in enumerate(toks, start=1):
            p.insert(t, pos)
        sess.update(p)
    for d in erase:
        sess.erase(d)
    return sess.commit()


@pytest.fixture(scope="module")
def seg():
    rng = np.random.default_rng(5)
    docs = {}
    for d in range(1, 301):
        toks = [f"t{int(i)}" for i in rng.integers(0, 12, size=20)]
        if d % 3 == 0:
            toks[2:4] = ["t0", "t1"]
        if d % 4 == 0:
            toks[5:8] = ["t5", "t6", "t7"]
        docs[2 * d] = toks
    s = _segment(docs)
    assert s.positions_distinct
    return s


@pytest.fixture
def tracer():
    tr = get_tracer()
    tr.record(False)
    tr.reset()
    yield tr
    tr.record(False)
    tr.reset()


def _mixed_executor(seg):
    """An executor whose bigrams take the posmask path and whose trigrams
    the lazy one (the posmask group declined for three members)."""
    ex = Executor(seg, device="cpu")
    assert ex._posmask_enabled
    pos = ex._prep_phrase_pos
    ex._prep_phrase_pos = lambda key, members, k, ctx: (
        None if len(key[1]) == 3 else pos(key, members, k, ctx))
    return ex


def _inside(recs, i):
    """Record i lies inside its parent's interval."""
    name, a, b, parent, _, _ = recs[i]
    assert a <= b, recs[i]
    if parent >= 0:
        _, pa, pb, _, _, _ = recs[parent]
        assert pa <= a and b <= pb, (recs[i], recs[parent])


def _chain(recs, i):
    """Indices of record i's ancestors, innermost first."""
    out = []
    while recs[i][3] >= 0:
        i = recs[i][3]
        out.append(i)
    return out


def test_batch_span_tree(seg, tracer):
    ex = _mixed_executor(seg)
    queries = BOOLEAN + [BIGRAM, TRIGRAM]
    kinds = {g.kind for g in ex.plan_batch(queries)}
    assert kinds == {"flat", "posph", "lazyph"}
    want = [ex.search_batch(queries)]
    want.append(ex.search_batch(queries[::-1]))
    tracer.reset()
    tracer.record(True)
    h1 = ex.launch_batch(queries)
    h2 = ex.launch_batch(queries[::-1])
    got = [ex.finish_batch(h1), ex.finish_batch(h2)]
    tracer.record(False)
    assert got == want
    recs = tracer.intervals()
    assert recs and all(r is not None for r in recs)
    assert tracer.intervals() == []
    for i in range(len(recs)):
        _inside(recs, i)
    launches = [i for i, r in enumerate(recs) if r[0] == "exec.launch"]
    finishes = [i for i, r in enumerate(recs) if r[0] == "exec.finish"]
    assert len(launches) == len(finishes) == 2
    ids = [recs[i][4] for i in launches]
    assert ids[0] != ids[1]
    assert [recs[i][4] for i in finishes] == ids
    assert h1[-1] == ids[0] and h2[-1] == ids[1]
    for li, fi, bid in zip(launches, finishes, ids):
        under = [r for r in recs if r[3] == li]
        names = {r[0] for r in under} - {"host.gc"}
        assert names == {"exec.prepare", "exec.group.flat",
                         "exec.group.posph", "exec.group.lazyph"}
        for j, r in enumerate(recs):
            if li in _chain(recs, j) or fi in _chain(recs, j):
                assert r[4] == bid, r
        assert all(set(r[5]) == {"B", "T"} for r in under
                   if r[0].startswith("exec.group."))
        phrase_parents = {recs[r[3]][0] for r in recs
                          if r[0] == "exec.phrase"
                          and r[3] >= 0 and r[4] == bid}
        assert phrase_parents == {"exec.group.posph", "exec.group.lazyph"}
        assert [r[0] for r in recs if r[3] == fi
                and r[0] != "host.gc"] == ["exec.device"]
        assert recs[fi][4] == bid
    snap = tracer.snapshot()
    assert snap["exec.launch"]["count"] == 2
    assert snap["exec.group.flat"]["count"] == 2


def test_search_shares_one_batch(seg, tracer):
    """search(): exec.search around exec.launch and exec.finish, every span
    of the call under one batch id."""
    ex = Executor(seg, device="cpu")
    tracer.record(True)
    ex.search(BIGRAM)
    tracer.record(False)
    recs = tracer.intervals()
    mine = [i for i, r in enumerate(recs) if r[0] != "host.gc"]
    (top,) = [i for i in mine if recs[i][3] == -1]
    assert recs[top][0] == "exec.search"
    (launch,) = [i for i in mine if recs[i][0] == "exec.launch"]
    assert recs[launch][3] == top
    assert {recs[i][0] for i in mine if recs[i][3] == top} == {
        "exec.launch", "exec.finish"}
    assert all(top in _chain(recs, i) for i in mine if i != top)
    assert {recs[i][4] for i in mine} == {recs[launch][4], None} - (
        {None} if recs[top][4] is not None else set())


def test_collection_spans(tracer):
    base = {d: f"w{d % 5} w{d % 7} apple pie".split() for d in range(1, 60)}
    g1 = _segment(base)
    g2 = _segment({100: "apple pie crust".split()},
                  update={3: "apple tart".split()})
    g3 = _segment({}, erase=[5, 6])
    assert g3.n_docs == 0
    coll = IndexSourcesCollection(device="cpu")
    for s, gen in ((g1, 1), (g2, 2), (g3, 3)):
        coll.add_segment(s, generation=gen)
    coll.commit()
    want = coll.search_batch(["apple", '"apple pie"', "w1 OR w2"])
    tracer.record(True)
    h = coll.launch_batch(["apple", '"apple pie"', "w1 OR w2"])
    got = coll.finish_batch(h)
    tracer.record(False)
    assert got == want
    recs = tracer.intervals()
    for i in range(len(recs)):
        _inside(recs, i)
    (cl,) = [i for i, r in enumerate(recs) if r[0] == "collection.launch"]
    (cf,) = [i for i, r in enumerate(recs) if r[0] == "collection.finish"]
    live = [i for i, r in enumerate(recs) if r[3] == cl
            and r[0] == "exec.launch"]
    assert len(live) == 2  # the erase-only source launches nothing
    assert {recs[i][5]["source"] for i in live} == {
        src.executor()._serial for src in coll.sources if src.seg.n_docs}
    under = [r[0] for r in recs if r[3] == cf and r[0] != "host.gc"]
    assert under == ["exec.finish", "exec.finish", "collection.merge"]
    (merge,) = [r for r in recs if r[0] == "collection.merge"]
    assert merge[5] == {"sources": 2}
    bid = h[-1]
    assert recs[cl][4] == recs[cf][4] == bid
    assert {r[4] for r in recs if r[0] != "host.gc"} == {bid}


def test_recording_off_keeps_nothing(tracer):
    for _ in range(5):
        with timings.trace("t.off"):
            pass
    tracer.add("t.count", 3)
    assert tracer.intervals() == []
    snap = tracer.snapshot()
    assert snap["t.off"]["count"] == 5 and snap["t.off"]["total_ms"] >= 0
    assert snap["t.count"]["count"] == 3
    assert snap["t.count"]["total_ms"] == 0


def test_intervals_on_the_perf_counter_clock(tracer):
    tracer.record(True)
    t0 = time.perf_counter_ns()
    with timings.trace("t.outer", batch=7, x=1):
        with timings.trace("t.inner"):
            time.sleep(0.001)
    t1 = time.perf_counter_ns()
    tracer.record(False)
    recs = tracer.intervals()
    names = [r[0] for r in recs]
    o, i = names.index("t.outer"), names.index("t.inner")
    (_, a, b, p, bid, attrs), (_, ia, ib, ip, ibid, iattrs) = recs[o], recs[i]
    assert t0 <= a <= ia <= ib <= b <= t1 and ib - ia >= 1_000_000
    assert (p, ip, bid, ibid, attrs, iattrs) == (-1, o, 7, 7, {"x": 1}, {})
    assert tracer.snapshot()["t.inner"]["total_ms"] == pytest.approx(
        (ib - ia) / 1e6)


def test_cap_drops_and_counts():
    tr = Tracer(cap=5)
    tr.record(True)
    with tr.trace("outer"):
        for _ in range(7):
            with tr.trace("inner"):
                pass
    tr.record(False)
    recs = tr.intervals()
    assert len(recs) == 5 and tr.dropped == 3
    assert [r[0] for r in recs] == ["outer"] + ["inner"] * 4
    assert all(r[3] == 0 for r in recs[1:])
    assert tr.snapshot()["inner"]["count"] == 7


def test_span_open_across_a_read_is_dropped():
    tr = Tracer()
    tr.record(True)
    with tr.trace("open"):
        with tr.trace("closed"):
            pass
        read = tr.intervals()
    tr.record(False)
    assert read[0] is None and read[1][0] == "closed" and read[1][3] == 0
    assert tr.intervals() == [] and tr.dropped == 1
    assert tr.snapshot()["open"]["count"] == 1


class _Yielding(defaultdict):
    """A dict that gives up the interpreter lock inside each read, as a
    preempting scheduler would: an update made outside the tracer's lock
    then loses the ones other threads make meanwhile."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_threads_give_exact_totals():
    """16 threads of 1,000 spans and adds each: counts and totals exact
    (the totals equal the recorded intervals' sum to the nanosecond), with
    the tracer's tables yielding between each read and its write."""
    tr = Tracer()
    tr._totals_ns, tr._counts = _Yielding(int), _Yielding(int)
    tr.record(True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    go = threading.Barrier(16, timeout=60)

    def work():
        go.wait()
        for _ in range(1000):
            with tr.trace("t.span"):
                pass
            tr.add("t.add")

    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    tr.record(False)
    snap = tr.snapshot()
    recs = [r for r in tr.intervals() if r[0] == "t.span"]
    assert snap["t.span"]["count"] == 16_000
    assert snap["t.add"]["count"] == 16_000
    assert len(recs) == 16_000 and tr.dropped == 0
    assert round(snap["t.span"]["total_ms"] * 1e6) == sum(
        b - a for _, a, b, _, _, _ in recs)


def test_gc_is_a_span(tracer):
    tracer.record(True)
    with timings.trace("t.around", batch=3):
        gc.collect()
    tracer.record(False)
    recs = tracer.intervals()
    (around,) = [i for i, r in enumerate(recs) if r[0] == "t.around"]
    mine = [r for r in recs if r[0] == "host.gc" and r[3] == around]
    assert mine and mine[-1][5] == {"generation": 2} and mine[-1][4] == 3
    _inside(recs, recs.index(mine[-1]))
    assert tracer.snapshot()["host.gc"]["count"] >= 1


def test_only_the_process_tracer_times_collections():
    """A tracer made apart from get_tracer() installs no gc callback, so
    throwaway tracers leave no work behind in later collections."""
    before = list(gc.callbacks)
    tr = Tracer()
    tr.record(True)
    with tr.trace("t.alone"):
        gc.collect()
    tr.record(False)
    assert gc.callbacks == before
    assert [r[0] for r in tr.intervals()] == ["t.alone"]
    with timings.trace("t.process"):
        pass
    assert sum(getattr(cb, "__qualname__", "").startswith(
        "Tracer._hook_gc") for cb in gc.callbacks) == 1


def test_df_lookups_count_the_plans_calls(seg, tracer):
    ex = _mixed_executor(seg)
    calls = []

    def df_of(term):
        calls.append(term)
        return int(seg.term_df[seg.term_id(term)])

    queries = BOOLEAN + [BIGRAM, TRIGRAM, "t0 (t1 OR t2)"]
    ex.plan_batch(queries, df_of=df_of)
    ex.plan_batch(queries[:2], df_of=df_of)
    assert len(calls) > len(queries)
    assert tracer.snapshot()["plan.df_lookups"]["count"] == len(calls)


def test_reference_interface(tracer):
    """What the reference's tracer offers, as the port's keeps it:
    ``trace(name)`` as a context manager, ``add``, ``snapshot`` with
    total_ms / count / avg_us, ``reset``, ``get_tracer`` and the
    module-level ``trace``."""
    assert get_tracer() is timings.get_tracer() is timings._tracer
    with timings.trace("t.ref"):
        time.sleep(0.0005)
    with tracer.trace("t.ref"):
        pass
    tracer.add("t.ref.n")
    tracer.add("t.ref.n", 4)
    snap = tracer.snapshot()
    assert set(snap["t.ref"]) == {"total_ms", "count", "avg_us"}
    assert snap["t.ref"]["count"] == 2
    assert snap["t.ref"]["total_ms"] >= 0.5
    assert snap["t.ref"]["avg_us"] == pytest.approx(
        snap["t.ref"]["total_ms"] * 1e3 / 2)
    assert snap["t.ref.n"] == {"total_ms": 0.0, "count": 5, "avg_us": 0.0}
    tracer.reset()
    assert "t.ref" not in tracer.snapshot()
