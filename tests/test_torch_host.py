"""The port's own copies of the JAX package's host modules agree with it.

- The same documents through both packages' SegmentIndexSession give
  segments equal array by array: the begin/insert route with positions and
  deletions (erase), and the bulk_index_ids route.
- A segment persisted by either package loads in the other, equal.
- parse_query and compile_plan agree (AST, its text, tapes, term lists,
  weight terms) on every query of the port's tests and on bench.py's
  query generator over a small corpus.
- The two packages' Config() defaults and limits are equal.
- chip_smoke's corpus build, at a small N_DOCS / VOCAB, writes the same
  docs.bin bytes and the same segment as bench._build_corpus_fresh.
- The whole-module copies (utils/timings.py, utils/metrics.py,
  index/merge.py, query/rewrite.py) differ from the originals only in the
  package their imports name; rich-match's host half
  (exec/richmatch.py), the spec evaluator it re-checks phrases with
  (exec/speceval.py, from trinity_tpu/oracle.py) and
  intersection_alternatives equal the originals' source; exec/planning.py's copies of ExecFlags, _flatten_tape and
  the pruned search's _tape_matches_empty / _tape_window_bounds equal the
  originals' source, and the two bound helpers give the reference's values
  on a 2-window segment.
"""

import dataclasses
import os

import numpy as np
import pytest

import bench
import chip_smoke
import test_torch_cuda
import test_torch_executor
import test_torch_phrases
import trinity_tpu.config as ref_config
import trinity_tpu.limits as ref_limits
import trinity_tpu_torch.config as port_config
import trinity_tpu_torch.limits as port_limits
from torch_twins import assert_same_segment, build_pair, bulk_pair
from trinity_tpu.index.format import SegmentData as RefSegmentData
from trinity_tpu.plan.compile import compile_plan as ref_compile
from trinity_tpu.query.parser import parse_query as ref_parse
from trinity_tpu_torch.index.format import SegmentData as PortSegmentData
from trinity_tpu_torch.plan.compile import compile_plan as port_compile
from trinity_tpu_torch.query.parser import parse_query as port_parse


def _docs(seed=11, n=600, vocab=40):
    rng = np.random.default_rng(seed)
    return {int(d): [f"t{int(t)}" for t in rng.integers(0, vocab, size=int(
        rng.integers(1, 90)))] for d in rng.choice(10 * n, n, replace=False)}


def test_builders_agree_with_positions_and_deletions():
    """begin/insert with positions (some repeated within a doc, runs past
    128 positions), payload-free, plus erased ids: equal segments."""
    docs = _docs()

    def fill(sess):
        for d, toks in docs.items():
            p = sess.begin(d)
            for pos, t in enumerate(toks, start=1):
                p.insert(t, pos)
            if d % 5 == 0:
                p.insert(toks[0], 1)  # a repeated (term, position)
            sess.insert(p)
        for d in (3, 17, 50_000):
            sess.erase(d)

    seg, _ = build_pair(fill)
    assert seg.n_docs == len(docs) and len(seg.updated_ids) > 0
    assert not seg.positions_distinct and seg.max_position > 80


def test_builders_agree_bulk_route():
    rng = np.random.default_rng(4)
    n_docs, vocab = 20_000, 300
    zipf = 1.0 / np.arange(1, vocab + 1)
    zipf /= zipf.sum()
    bounds = np.zeros(n_docs + 1, np.int64)
    np.cumsum(rng.integers(1, 30, size=n_docs), out=bounds[1:])
    toks = rng.choice(vocab, size=int(bounds[-1]), p=zipf)
    seg, _ = bulk_pair(np.arange(n_docs) * 5 + 2, toks, bounds,
                       [f"w{i}" for i in range(vocab)])
    assert seg.n_windows == 2 and seg.positions_distinct


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_persisted_segment_loads_in_the_other(tmp_path, writer):
    seg, ref = build_pair(lambda s: s.bulk_index_ids(
        np.arange(500), np.arange(2000) % 37, np.arange(0, 2001, 4),
        [f"x{i}" for i in range(37)]))
    (seg if writer == "port" else ref).persist(str(tmp_path / "seg"))
    got = PortSegmentData.load(str(tmp_path / "seg"))
    want = RefSegmentData.load(str(tmp_path / "seg"))
    assert_same_segment(got, want)
    assert got.n_terms == seg.n_terms and got.term_id("x5") == seg.term_id("x5")
    np.testing.assert_array_equal(got.planes, seg.planes)


def _test_queries():
    """The query strings of the port's tests."""
    qs = list(test_torch_executor.QUERIES) + list(test_torch_phrases.QUERIES)
    qs += test_torch_cuda.QUERIES + test_torch_cuda.PHRASE_QUERIES
    qs += ["a c", "a OR d", "c NOT b", "(a b) OR (c d)", '"a b"', '"b c" OR d',
           '"c a" a', "", "NOT a", "<a>", "a a b", '"a"', "[a, b, c]/4"]
    return qs


class _Tiered:
    """A small segment whose document frequencies are scaled up, so that
    bench.make_queries finds its hot / mid / rare tiers in it."""

    def __init__(self, seg, scale):
        self.term_id = seg.term_id
        self.term_df = np.asarray(seg.term_df).astype(np.int64) * scale


def _bench_queries(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "N_DOCS", 40_000)
    monkeypatch.setattr(bench, "VOCAB", 20_000)
    monkeypatch.setattr(bench, "CACHE_ROOT", str(tmp_path))
    seg = chip_smoke.build_corpus()
    texts, _ = bench.make_queries(_Tiered(seg, 30),
                                  np.random.default_rng(bench.SEED + 1))
    return texts


def test_parser_and_plan_compiler_agree(monkeypatch, tmp_path):
    qs = _test_queries() + _bench_queries(monkeypatch, tmp_path)
    assert len(qs) > 150 and any(q.startswith('"') for q in qs)
    for q in qs:
        got, want = port_parse(q), ref_parse(q)
        assert repr(got.root) == repr(want.root), q
        assert str(got) == str(want), q
        assert got.tokens_count == want.tokens_count, q
        if want.root is None:
            continue
        a, b = port_compile(got.root), ref_compile(want.root)
        assert (a.tape, a.term_texts, a.weight_terms, a.has_phrase) == (
            b.tape, b.term_texts, b.weight_terms, b.has_phrase), q


def test_config_defaults_and_limits_equal():
    assert (dataclasses.asdict(port_config.Config())
            == dataclasses.asdict(ref_config.Config()))
    names = [n for n in dir(ref_limits) if n.isupper()]
    assert names
    for n in names:
        assert getattr(port_limits, n) == getattr(ref_limits, n), n


def test_configure_reaches_only_its_own_package():
    """The two packages keep separate configs: configuring one leaves the
    other as it was (tests steer each package with its own configure)."""
    before = ref_config.get_config().posmask_min_df
    old = port_config.get_config().posmask_min_df
    port_config.configure(posmask_min_df=before + 1)
    try:
        assert ref_config.get_config().posmask_min_df == before
        assert port_config.get_config().posmask_min_df == before + 1
    finally:
        port_config.configure(posmask_min_df=old)


def test_chip_smoke_corpus_equals_bench_corpus(monkeypatch, tmp_path):
    """chip_smoke.build_corpus (the port's builder) against
    bench._build_corpus_fresh (the JAX package's) on bench's token draw at
    a small size: docs.bin byte for byte, and the persisted segments."""
    monkeypatch.setattr(bench, "N_DOCS", 5_000)
    monkeypatch.setattr(bench, "VOCAB", 3_000)
    out = {}
    for name, build in (("port", chip_smoke.build_corpus),
                        ("bench", bench._build_corpus_fresh)):
        monkeypatch.setattr(bench, "CACHE_ROOT", str(tmp_path / name))
        build()
        with open(bench._docs_bin(), "rb") as f:
            out[name] = (f.read(), os.path.join(bench._cache_dir(), "seg"))
    assert out["port"][0] == out["bench"][0]
    assert len(out["port"][0]) > 5_000 * 40 * 4
    assert_same_segment(PortSegmentData.load(out["port"][1]),
                        RefSegmentData.load(out["bench"][1]))


def _port_text(text):
    """A port copy's source as its original would read: without the
    copy's first-line note, the port's package named as the original."""
    first, rest = text.split("\n", 1)
    assert first.startswith("# Copy of trinity_tpu/"), first
    return rest.replace("trinity_tpu_torch", "trinity_tpu")


@pytest.mark.parametrize("rel", ["utils/timings.py", "utils/metrics.py",
                                 "index/merge.py", "query/rewrite.py"])
def test_module_copies_equal_originals(rel):
    """The port's copies of whole host modules differ from the originals
    only in the package their imports name."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "trinity_tpu_torch", rel)) as f:
        got = _port_text(f.read())
    with open(os.path.join(root, "trinity_tpu", rel)) as f:
        assert got == f.read()


@pytest.mark.parametrize("name", ["ExecFlags", "_tape_matches_empty",
                                  "_tape_window_bounds", "_flatten_tape"])
def test_planning_helpers_equal_originals(name):
    """exec/planning.py's copies of the executor's helpers, by source."""
    import inspect

    import trinity_tpu.exec.executor as ref_executor
    import trinity_tpu_torch.exec.planning as planning

    got = inspect.getsource(getattr(planning, name))
    assert got.replace("trinity_tpu_torch", "trinity_tpu") == (
        inspect.getsource(getattr(ref_executor, name)))


RICH_HOST = ["AbortSearch", "TermHit", "MatchedTerm", "QueryIndexTerm",
             "TermInstance", "QueryTermCtx", "collect_query_index_terms",
             "MatchedDocument", "DocWordsSpace", "_relax_tape"]


@pytest.mark.parametrize("port,ref,name", [
    *(("exec.richmatch", "exec.richmatch", n) for n in RICH_HOST),
    *(("exec.speceval", "oracle", n) for n in ("phrase_freq", "Scorer",
                                                "_eval")),
    ("query.intersect", "query.intersect", "intersection_alternatives"),
])
def test_host_copies_equal_originals(port, ref, name):
    """The port's copies of single classes and functions, by source."""
    import importlib
    import inspect

    got = inspect.getsource(getattr(
        importlib.import_module(f"trinity_tpu_torch.{port}"), name))
    want = inspect.getsource(getattr(
        importlib.import_module(f"trinity_tpu.{ref}"), name))
    assert got.replace("trinity_tpu_torch", "trinity_tpu") == want


TAPES = ["t0", "t0 t1", "t0 OR <t1>", "<t1> OR t0", "t0 NOT t1", "t0 OR NOT t1",
         "[t0, t1, t2]/2", "(t0 t1) OR (t2 t3)", "(t0 OR t3) t5",
         "t0 ([t1,t5] OR t13)", "(t3 OR t9) NOT (t0 t1)", "t0 <t2>"]


def test_pruned_bounds_equal_reference():
    """_tape_matches_empty and _tape_window_bounds (f32 sums in tape order)
    give the reference's values on a 2-window segment."""
    from trinity_tpu.exec import executor as ref_executor
    from trinity_tpu.models.similarity import SIMILARITIES as REF_SIM
    from trinity_tpu.ops.postings import compute_cells as ref_cells
    from trinity_tpu_torch.exec import planning
    from trinity_tpu_torch.models.similarity import SIMILARITIES
    from trinity_tpu_torch.ops.postings import compute_cells

    rng = np.random.default_rng(5)
    n_docs = 20_000
    bounds = np.zeros(n_docs + 1, np.int64)
    np.cumsum(rng.integers(1, 12, size=n_docs), out=bounds[1:])
    zipf = 1.0 / np.arange(1, 41)
    toks = rng.choice(40, size=int(bounds[-1]), p=zipf / zipf.sum())
    seg, ref_seg = bulk_pair(np.arange(n_docs), toks, bounds,
                             [f"t{i}" for i in range(40)])
    for q in TAPES:
        plan = port_compile(port_parse(q).root)
        empty = planning._tape_matches_empty(plan.tape)
        assert empty == ref_executor._tape_matches_empty(plan.tape), q
        if empty:
            continue
        tids = [seg.term_id(t) for t in plan.term_texts]
        w = rng.random(len(plan.weight_terms)).astype(np.float32) * 3
        for scorer in ("bm25", "tfidf", "trivial"):
            got = planning._tape_window_bounds(
                seg, plan.tape, *compute_cells(seg, tids), w,
                SIMILARITIES[scorer], col=lambda s: s)
            want = ref_executor._tape_window_bounds(
                ref_seg, plan.tape, *ref_cells(ref_seg, tids), w,
                REF_SIM[scorer], col=lambda s: s)
            for g, x in zip(got, want):
                assert g.dtype == x.dtype
                np.testing.assert_array_equal(g, x, err_msg=q)
    assert seg.n_windows == 2


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117flat_score_kernelILi8EEEvPKiS2_PKfS2_S2_S2_S4_iiS4_iiiiPfS5_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117flat_score_kernelILi8EEEvPKiS2_PKfS2_S2_S2_S4_iiS4_iiiiPfS5_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 168 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117tape_score_kernelILi4ELi4EEEvPKiS2_S2_S2_PKfiS2_PK4int4iS2_iS4_iiS4_iiiiPfS9_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117tape_score_kernelILi4ELi4EEEvPKiS2_S2_S2_PKfiS2_PK4int4iS2_iS4_iiS4_iiiiPfS9_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119decode_tiles_kernelEPKiS1_S1_S1_S1_iPfxxPi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119decode_tiles_kernelEPKiS1_S1_S1_S1_iPfxxPi
    {stack} bytes stack frame, 0 bytes spill stores, {spill} bytes spill loads
ptxas info    : Used 40 registers
"""


@pytest.mark.parametrize("stack,spill,bad", [
    (0, 0, {}), (8, 0, {"decode_tiles_kernel": [40, 8, 0, 0]}),
    (0, 4, {"decode_tiles_kernel": [40, 0, 0, 4]})])
def test_chip_smoke_ptxas_check(stack, spill, bad):
    """chip_smoke's ptxas check reads templated and plain kernel names and
    fails on a stack frame, a spill or a missing kernel."""
    report = chip_smoke.ptxas_report(PTXAS_LOG.format(stack=stack,
                                                      spill=spill))
    assert report["flat_score_kernel<8>"] == [72, 0, 0, 0]
    assert report["tape_score_kernel<4,4>"] == [56, 0, 0, 0]
    assert chip_smoke.stack_faults(report) == bad
    del report["flat_score_kernel<8>"]
    assert "flat_score_kernel" in chip_smoke.stack_faults(report)
