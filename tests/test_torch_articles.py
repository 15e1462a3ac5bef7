"""The port on article-length documents: 140-200 tokens a document, about
1 KB of text (the shape of luceneutil's wikimedium sets), drawn by
``benchmark/corpus.py`` under the bench corpus's Zipf law, 4,096 documents
over 4,096 terms.

- Positions past 128 turn the posmask route off, so every pure phrase runs
  the lazy route.
- The port's answers on the bench mix and on phrases alone (batches of
  120) pass the benchmark's own comparison with ``benchmark/reference.py``
  (``benchmark/compare.judge``), for three seeds.
- The lazy route in chunks of one row (a workspace that holds one row)
  equals it in one chunk a group bit for bit, in ids and scores, on the
  device verifier and on the host verifier.
- Verification that builds its live index in slices of 1,000 candidates
  equals it in one slice, bit for bit.
- The workspace is one buffer an executor; a small segment reserves its
  widest row, less than the 64 MiB cap.
- The counters ``phrase.candidates``, ``phrase.lazy_chunks`` and
  ``phrase.syncs`` count.
"""

import pytest

from benchmark import compare, corpus, harness, querygen
from benchmark.reference import Reference
from trinity_tpu_torch.exec import executor as executor_mod
from trinity_tpu_torch.exec import phrases
from trinity_tpu_torch.limits import WINDOW_SIZE
from trinity_tpu_torch.utils.timings import get_tracer

CFG = {"docs": 4096, "vocab": 4096, "zipf_s": 1.07, "doc_len": [140, 200],
       "generations": []}
SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]
# the benchmark's df tiers scaled to 4,096 documents (benchmark/tests/tiny.py)
TIERS = {"hot": [800, None], "mid": [20, 800], "rare": [2, 20]}


# phrases alone: two bigrams to a trigram, each a run of distinct adjacent
# tokens of a random document (querygen's phrase node)
PHRASES = [{"name": "phrase2", "per_cycle": 2, "node": "phrase", "width": 2},
           {"name": "phrase3", "per_cycle": 1, "node": "phrase", "width": 3}]


def _traffic(name: str) -> dict:
    """One batch of 120 of the bench mix ("mix") or of phrases alone
    ("phrase"), under mix.batch's loop."""
    t = dict(harness.load_traffic("mix.batch"), tiers=TIERS,
             tier_probes=600, pool_batches=1)
    return dict(t, classes=PHRASES) if name == "phrase" else t


@pytest.fixture(scope="module")
def articles():
    """{seed: (source, segment)}, each drawn once."""
    names = corpus.term_names(CFG["vocab"])
    out = {}
    for seed in SEEDS:
        src = corpus.draw_sources(CFG, seed, "cpu")[0]
        out[seed] = (src, corpus.build_segment(src, names))
    return out


def _pool(src, traffic: str, seed: int) -> list:
    df = querygen.doc_freq(src, CFG["vocab"], "cpu")
    return querygen.make_pool(_traffic(traffic), src, df, seed)


def _counts() -> dict:
    snap = get_tracer().snapshot()
    return {n: snap.get(n, {}).get("count", 0)
            for n in ("phrase.candidates", "phrase.lazy_chunks",
                      "phrase.syncs")}


@pytest.mark.parametrize("traffic", ["mix", "phrase"])
@pytest.mark.parametrize("seed", SEEDS)
def test_articles_match_the_reference(articles, traffic, seed):
    src, seg = articles[seed]
    ex = executor_mod.Executor(seg, device="cpu")
    assert seg.max_position >= 139 and not ex._posmask_enabled
    pool = _pool(src, traffic, seed)
    texts = [q for q, _ in pool]
    kinds = {g.kind for g in ex.plan_batch(texts)}
    assert "lazyph" in kinds and "posph" not in kinds
    before = _counts()
    res = ex.search_batch(texts, k=10)
    after = _counts()
    # every phrase verified on the device: candidates, one chunk or more a
    # lazy group, and a synchronisation for each verification's live count
    assert all(after[n] > before[n] for n in after), (before, after)
    answers = {i: {tuple((r.doc_id, r.score) for r in rs)}
               for i, rs in enumerate(res)}
    nums = compare.judge(Reference([src], CFG["vocab"], "cpu"), pool,
                         answers, 10, 0)
    assert nums["answers"] == len(pool)
    assert compare.correct(nums), nums


def _one_row_budget(ex, groups) -> int:
    """A workspace that holds one row of the group with the smallest rows,
    so every lazy group runs one row a chunk (rows larger than it in a
    buffer of their own)."""
    W = ex.seg.n_windows
    n = W * WINDOW_SIZE
    return min(executor_mod._lazy_bytes(
        W, 1, g.T, len(g.tape[1]),
        g.ctx["C2"] if g.kind == "lazyph" else min(g.ctx["C2"], n),
        g.kind == "lazyph") for g in groups)


@pytest.mark.parametrize("route", ["lazyph", "lazyhost"])
def test_one_row_chunks_equal_one_chunk(articles, route, monkeypatch):
    src, seg = articles[SEEDS[0]]
    texts = [q for q, _ in _pool(src, "phrase", SEEDS[0])]
    out, chunks = [], []
    for budget in ("one chunk", "one row"):
        ex = executor_mod.Executor(seg, device="cpu")
        if route == "lazyhost":
            ex._phrase_fcaps = lambda *a: None
        groups = ex.plan_batch(texts)
        assert {g.kind for g in groups} == {route}
        size = 1 << 30 if budget == "one chunk" else _one_row_budget(
            ex, groups)
        monkeypatch.setattr(executor_mod, "_lazy_workspace_bytes",
                            lambda W, size=size: size)
        before = _counts()["phrase.lazy_chunks"]
        out.append(ex.search_batch(texts, k=10))
        chunks.append(_counts()["phrase.lazy_chunks"] - before)
    assert chunks == [len(groups), len(texts)]
    for q, a, b in zip(texts, *out):
        assert [(r.doc_id, r.score) for r in a] == [
            (r.doc_id, r.score) for r in b], q
    assert sum(1 for a in out[0] if a) > len(texts) // 2


def test_live_slices_equal_one_slice(articles, monkeypatch):
    src, seg = articles[SEEDS[2]]
    texts = [q for q, _ in _pool(src, "phrase", SEEDS[2])]
    out, counts = [], []
    for live_slice in (None, 1000):
        if live_slice:
            monkeypatch.setattr(phrases, "LIVE_SLICE", live_slice)
        before = _counts()
        out.append(executor_mod.Executor(seg, device="cpu").search_batch(
            texts, k=10))
        counts.append({n: c - before[n] for n, c in _counts().items()})
    # the same candidates, each slice's live count read on its own
    assert counts[1]["phrase.candidates"] == counts[0]["phrase.candidates"]
    assert counts[1]["phrase.syncs"] > counts[0]["phrase.syncs"]
    for q, a, b in zip(texts, *out):
        assert [(r.doc_id, r.score) for r in a] == [
            (r.doc_id, r.score) for r in b], q


def test_workspace_is_one_fixed_buffer(articles):
    """The first lazy group reserves the workspace; later groups reuse it."""
    src, seg = articles[SEEDS[1]]
    ex = executor_mod.Executor(seg, device="cpu")
    texts = [q for q, _ in _pool(src, "phrase", SEEDS[1])]
    assert {g.kind for g in ex.plan_batch(texts)} == {"lazyph"}
    assert ex._lazy_ws is None
    ex.search_batch(texts[:60], k=10)
    ws = ex._lazy_ws
    assert ws.numel() == executor_mod._lazy_workspace_bytes(seg.n_windows)
    # the segment arrays and the workspace (no hot cache, no mask)
    assert ex.device_bytes_held == ex.device_bytes + ws.numel()
    ex.search_batch(texts[60:], k=10)
    assert ex._lazy_ws is ws


def test_small_segment_reserves_its_widest_row(articles):
    """Below 64 MiB of widest row a segment's workspace is that row (the
    widest phrase at C = n): a one-window segment reserves about 4.3 MB
    and still runs a batch of phrases in chunks of several rows; the full
    LAZY_WORKSPACE_BYTES is the cap from about 253,000 docids up."""
    src, seg = articles[SEEDS[0]]
    W = seg.n_windows
    n = W * WINDOW_SIZE
    widest = executor_mod._lazy_bytes(W, 1, 16, 16, n, True)
    assert executor_mod._lazy_workspace_bytes(W) == widest
    assert widest < 5 << 20 < executor_mod.LAZY_WORKSPACE_BYTES
    assert executor_mod._lazy_workspace_bytes(32) == (
        executor_mod.LAZY_WORKSPACE_BYTES)
    ex = executor_mod.Executor(seg, device="cpu")
    texts = [q for q, _ in _pool(src, "phrase", SEEDS[0])]
    groups = ex.plan_batch(texts)
    before = _counts()["phrase.lazy_chunks"]
    ex.search_batch(texts, k=10)
    chunks = _counts()["phrase.lazy_chunks"] - before
    assert ex._lazy_ws.numel() == widest
    rows = [ex._lazy_rows(g, g.ctx["C2"], True) for g in groups]
    assert min(rows) > 1
    assert chunks == sum(-(-g.B // r) for g, r in zip(groups, rows))
