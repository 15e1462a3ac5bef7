"""The frozen corpus recipe and query generator: seeded, shares held, tiers measured."""

import numpy as np
import pytest

from benchmark import corpus, querygen
from benchmark.tests.tiny import tiny_cell

SEED = 2**31 + 11  # wider than 32 signed bits, as a run's seed may be


def draw(cell, seed):
    sources = corpus.draw_sources(cell.cfg, seed, "cpu")
    df = querygen.doc_freq(sources[0], cell.cfg["vocab"], "cpu")
    return sources, df, querygen.make_pool(cell.traffic, sources[0], df, seed)


@pytest.fixture(scope="module")
def drawn():
    cell = tiny_cell("abstracts1m-3gen.mix.batch")
    return cell, draw(cell, SEED)


def test_same_seed_same_tokens_and_pool(drawn):
    cell, (sources, _, pool) = drawn
    again, _, pool2 = draw(cell, SEED)
    assert pool == pool2
    for a, b in zip(sources, again):
        for f in ("ids", "bounds", "tokens", "shadows"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    other, _, pool3 = draw(cell, SEED + 1)
    assert not np.array_equal(sources[0].tokens[:1000], other[0].tokens[:1000])
    assert pool3 != pool


def test_negative_and_huge_seeds_draw():
    cell = tiny_cell(docs=256, vocab=512)
    for seed in (-5, 2**70 + 3):
        src = corpus.draw_sources(cell.cfg, seed, "cpu")[0]
        assert len(src.ids) == 256


def test_corpus_shape(drawn):
    cell, (sources, _, _) = drawn
    cfg = cell.cfg
    base = sources[0]
    lengths = np.diff(base.bounds)
    assert lengths.min() >= cfg["doc_len"][0]
    assert lengths.max() <= cfg["doc_len"][1]
    assert base.tokens.min() >= 0 and base.tokens.max() < cfg["vocab"]
    # Zipf: rank 0 is the most frequent term, about p(0) of all tokens
    p0 = corpus.zipf_cdf(cfg["vocab"], cfg["zipf_s"])[0]
    share = np.mean(base.tokens == 0)
    assert abs(share - p0) < 0.1 * p0
    # the generations: updates of base ids, new ids, erasures
    g2, g3 = sources[1], sources[2]
    upd = np.intersect1d(g2.ids, base.ids)
    assert len(upd) == 448 and len(g2.ids) == 512
    assert (np.setdiff1d(g2.ids, base.ids) >= cfg["docs"]).all()
    np.testing.assert_array_equal(g2.shadows, upd)
    assert len(g3.ids) == 0 and len(g3.shadows) == 64
    assert not np.intersect1d(g3.shadows, g2.ids).size


def test_mix_shares_hold_in_every_batch(drawn):
    cell, (_, _, pool) = drawn
    traffic = cell.traffic
    per_batch = traffic["batch"] // len(querygen.cycle(traffic))
    want = {c["name"]: c["per_cycle"] * per_batch for c in traffic["classes"]}
    assert sum(want.values()) == 120
    assert len(pool) == 1200 and len({t for t, _ in pool}) == 1200

    def kind(spec):
        if spec[0] == "phrase":
            return f"phrase{len(spec[1])}"
        if spec[0] == "not":
            return "not1" if spec[1][0] == "term" else "not2"
        if spec[0] == "some":
            return "kofn"
        if spec[0] == "or" and spec[1][0][0] == "and":
            return "or_of_and"
        n = len(spec[1])
        return {("and", 2): "and2", ("or", 3): "or3"}.get(
            (spec[0], n), f"{spec[0]}_wide")

    for b in querygen.batches(traffic, pool):
        got = {}
        for _, spec in b:
            got[kind(spec)] = got.get(kind(spec), 0) + 1
        assert got == want


def test_tiers_are_measured_on_the_seeds_segment(drawn):
    from trinity_tpu_torch import SegmentIndexSession

    cell, (sources, df, pool) = drawn
    base = sources[0]
    sess = SegmentIndexSession()
    sess.bulk_index_ids(base.ids, base.tokens.astype(np.int64), base.bounds,
                        corpus.term_names(cell.cfg["vocab"]))
    seg = sess.commit()
    for r in range(0, cell.cfg["vocab"], 7):
        tid = seg.term_id(f"w{r}")
        assert df[r] == (int(seg.term_df[tid]) if tid >= 0 else 0)
    pools = querygen.tier_pools(cell.traffic, df)
    for name, (lo, hi) in cell.traffic["tiers"].items():
        assert len(pools[name])
        assert (df[pools[name]] >= lo).all()
        if hi is not None:
            assert (df[pools[name]] < hi).all()
    tier_of = {int(t): n for n, p in pools.items() for t in p}
    for c, (_, spec) in zip(querygen.cycle(cell.traffic) * 30, pool):
        if c["node"] == "phrase":
            continue
        terms = [t for t in querygen.spec_terms(spec)[0]]
        assert all(t in tier_of for t in terms)


def test_texts_render_the_specs_and_parse(drawn):
    from trinity_tpu_torch import parse_query

    _, (_, _, pool) = drawn
    for text, spec in pool:
        assert querygen.render(spec) == text
    for text, _ in pool[:120]:
        assert parse_query(text).root is not None


def test_loop_files_share_one_mix():
    """mix.batch and mix.search take every key of mix.json and differ from
    each other only in their loop and their note."""
    from benchmark import harness

    mix = harness.load_traffic("mix")
    seen = set()
    for name in ("mix.batch", "mix.search"):
        t = harness.load_traffic(name)
        assert "base" not in t
        assert {k: v for k, v in t.items() if k not in ("about", "loop")} \
            == {k: v for k, v in mix.items() if k != "about"}
        seen.add(t["loop"])
    assert seen == {"pipelined", "blocking"}
