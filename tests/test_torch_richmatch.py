"""Twin of tests/test_richmatch.py: the port's rich-match mode (exec_rich)
on its CPU executor, against the JAX package's exec_rich (interpret mode,
as its own tests run it on the CPU) on the same documents, built by both
packages' builders (held equal).

Every case checks what its original checks, on the port, and holds the
port's whole callback stream equal to the JAX package's: per match, the
doc id, each matched term with its freq and hits (position, payload,
payload length), the DocWordsSpace, and the shared proximity context
(query_index_terms, term_ctxs); with the same return value.
"""

import numpy as np
import pytest

from torch_twins import build_pair, docs_pair
from trinity_tpu.exec import Executor as JaxExecutor
from trinity_tpu.exec.richmatch import AbortSearch as JaxAbortSearch
from trinity_tpu.exec.richmatch import collect_query_index_terms as jax_qit
from trinity_tpu.exec.richmatch import exec_rich as jax_exec_rich
from trinity_tpu.index.format import SegmentData as JaxSegmentData
from trinity_tpu.oracle import OracleCorpus, oracle_match_ids
from trinity_tpu.query.parser import parse_query as jax_parse
from trinity_tpu_torch import AbortSearch, Executor, exec_rich
from trinity_tpu_torch.exec.richmatch import collect_query_index_terms
from trinity_tpu_torch.index.format import SegmentData
from trinity_tpu_torch.query.parser import parse_query

DOCS = {
    10: "apple iphone case with apple logo",
    11: "samsung case",
    12: "apple macbook pro",
    13: "new york apple store",
    14: "case closed",
}


def pair(seg, ref):
    return Executor(seg, "cpu"), JaxExecutor(ref)


@pytest.fixture(scope="module")
def ex():
    return pair(*docs_pair({d: t.split() for d, t in DOCS.items()}))


def corpus():
    c = OracleCorpus()
    for d, text in DOCS.items():
        c.add(d, text.split())
    return c


def _qit(qit):
    return {i: [(q.term, q.flags, q.to_next_span) for q in v]
            for i, v in qit.items()}


def _ctxs(ctxs):
    return {t: [tuple(vars(i).values()) for i in c.instances]
            for t, c in ctxs.items()}


def record(md):
    """A MatchedDocument as plain values (either package's)."""
    return (md.doc_id,
            [(t.term, t.freq, [(h.pos, h.payload, h.payload_len,
                                h.payload_bytes()) for h in t.hits])
             for t in md.matched_terms],
            sorted(md.dws._pos.items()), _qit(md.query_index_terms),
            _ctxs(md.term_ctxs))


def both(exs, q, cb=None, **kw):
    """exec_rich on the port and on the JAX package; their streams (and
    return values) must be equal. cb(md, abort) is called on each match of
    both runs, with the package's AbortSearch class to raise. Returns the
    port's (matches, delivered)."""
    runs = []
    for run, e, abort in ((exec_rich, exs[0], AbortSearch),
                          (jax_exec_rich, exs[1], JaxAbortSearch)):
        got = []

        def on_match(md, got=got, abort=abort):
            got.append(md)
            if cb is not None:
                cb(md, abort)
        runs.append((got, run(e, q, on_match, **kw)))
    (got, n), (want, m) = runs
    assert [record(x) for x in got] == [record(x) for x in want], q
    assert n == m, q
    return got, n


def collect(exs, q):
    return both(exs, q)[0]


def test_matched_docs_order_and_terms(ex):
    got = collect(ex, "apple case")
    assert [m.doc_id for m in got] == [10]
    m = got[0]
    apple = m.term("apple")
    assert apple.freq == 2
    assert [h.pos for h in apple.hits] == [1, 5]
    assert m.term("case").freq == 1
    assert m.dws.test("apple", 1) and m.dws.test("case", 3)
    assert not m.dws.test("apple", 2)


def test_match_set_equals_oracle(ex):
    for q in ["apple", "apple OR case", "case -apple",
              "[apple, samsung, closed]"]:
        got = [m.doc_id for m in collect(ex, q)]
        want = oracle_match_ids(corpus(), jax_parse(q).root)
        assert got == want, q


def test_phrase_exact_in_rich_mode(ex):
    got = collect(ex, '"new york"')
    assert [m.doc_id for m in got] == [13]
    assert got[0].dws.test_phrase(["new", "york"], 1)
    # relaxed-candidate rejection: doc with both words non-adjacent
    assert collect(ex, '"york new"') == []
    # a negated phrase relaxes to const-false: the device mask stays a
    # superset, the exact re-check drops doc 13
    assert [m.doc_id for m in collect(ex, 'apple -"new york"')] == [10, 12]


def test_abort_search(ex):
    seen = []

    def cb(m, abort):
        seen.append(m.doc_id)
        raise abort

    got, n = both(ex, "apple OR case", cb)
    assert len(got) == 1 and n == 0
    assert seen == [got[0].doc_id] * 2  # once in each package


def test_optional_capture(ex):
    """<case> contributes capture when present but never gates matching."""
    got = collect(ex, "apple <case>")
    assert [m.doc_id for m in got] == [10, 12, 13]
    by_id = {m.doc_id: m for m in got}
    assert by_id[10].term("case") is not None
    assert by_id[12].term("case") is None


def test_payload_materialization():
    """term_hit payloads round-trip (runtime.h:8-20)."""
    def fill(sess):
        p = sess.begin(7)
        p.insert("alpha", 1, payload=0xBEEF)
        p.insert("beta", 2, payload=42)
        p.insert("alpha", 3, payload=0xCAFE)
        sess.insert(p)

    exs = pair(*build_pair(fill, track_payloads=True))
    got = collect(exs, "alpha beta")
    assert len(got) == 1
    alpha = got[0].term("alpha")
    assert [(h.pos, h.payload) for h in alpha.hits] == [(1, 0xBEEF),
                                                        (3, 0xCAFE)]
    assert got[0].term("beta").hits[0].payload == 42


def test_payload_len_bytes_roundtrip(tmp_path):
    """payloadLen round-trips through persist/load (codecs.h:176-200,
    runtime.h:8-20)."""
    def fill(sess):
        p = sess.begin(3)
        p.insert("alpha", 1, payload=b"\x01\x02")          # 2 bytes
        p.insert("alpha", 2, payload=0xBEEF, payload_len=3)  # explicit len
        p.insert("alpha", 3, payload=7)                    # int default: 8
        p.insert("beta", 4, payload=b"")                   # empty: len 0
        sess.insert(p)

    seg, ref = build_pair(fill, track_payloads=True)
    seg.persist(str(tmp_path / "port"))
    ref.persist(str(tmp_path / "ref"))
    exs = pair(SegmentData.load(str(tmp_path / "port")),
               JaxSegmentData.load(str(tmp_path / "ref")))
    got = collect(exs, "alpha beta")
    assert len(got) == 1
    hits = got[0].term("alpha").hits
    assert [(h.payload, h.payload_len) for h in hits] == [
        (0x0201, 2), (0xBEEF, 3), (7, 8)
    ]
    assert hits[0].payload_bytes() == b"\x01\x02"
    assert hits[1].payload_bytes() == b"\xef\xbe\x00"
    bh = got[0].term("beta").hits[0]
    assert (bh.payload, bh.payload_len, bh.payload_bytes()) == (0, 0, b"")


def test_proximity_metadata_scoring():
    """Score by term adjacency using only callback data (exec.cpp:694-873,
    matches.h:17-32)."""
    docs = {
        1: ["alpha", "beta", "filler"],        # adjacent, in order
        2: ["alpha", "filler", "beta"],        # both, not adjacent
        3: ["beta", "alpha", "x"],             # both, wrong order
        4: ["alpha", "x", "y"],                # alpha only -> no match
    }
    exs = pair(*docs_pair(docs))
    prepared = {}
    scores = {}

    def on_match(md, _abort):
        by_index = sorted(md.query_index_terms.items())
        base_terms = [cands[0].term for _, cands in by_index]
        s = 1.0
        first = md.term(base_terms[0])
        if first:
            for p0 in (h.pos for h in first.hits):
                pos = p0
                chain = 0
                for (idx, cands), nxt in zip(by_index, by_index[1:]):
                    span = cands[0].to_next_span
                    if md.dws.test(nxt[1][0].term, pos + span):
                        chain += 1
                        pos += span
                    else:
                        break
                s = max(s, 1.0 + chain)
        scores[md.doc_id] = s

    _, n = both(exs, "alpha beta", on_match, on_prepare=prepared.update)
    assert n == 3
    assert prepared, "on_prepare must receive query_index_terms"
    idxs = sorted(prepared)
    assert len(idxs) == 2
    assert prepared[idxs[0]][0].term == "alpha"
    assert prepared[idxs[1]][0].term == "beta"
    assert scores[1] > scores[2]
    assert scores[1] > scores[3]


def test_query_index_terms_disregard_flags():
    """DisregardTokenFlagsForQueryIndicesTerms (exec.h:36-42): dedup by
    (term, toNextSpan), flags zeroed; equal to the JAX package's."""
    from trinity_tpu.query import ast as jax_ast
    from trinity_tpu_torch.query import ast

    roots = []
    for mod in (ast, jax_ast):
        a1 = mod.Token("x")
        a1.flags = 1
        a2 = mod.Token("x")
        a2.flags = 2
        a1.index = a2.index = 0  # OR branches share a start
        roots.append(mod.BinOp(mod.Op.OR, a1, a2))
    _, qit = collect_query_index_terms(roots[0], disregard_token_flags=False)
    assert len(qit[0]) == 2  # distinct flags kept
    _, qit2 = collect_query_index_terms(roots[0], disregard_token_flags=True)
    assert len(qit2[0]) == 1 and qit2[0][0].flags == 0
    for flag in (False, True):
        got = collect_query_index_terms(roots[0], flag)
        want = jax_qit(roots[1], flag)
        assert _ctxs(got[0]) == _ctxs(want[0])
        assert _qit(got[1]) == _qit(want[1])


def test_phrase_member_indices():
    """Phrase members land at index+i with toNextSpan 1 except the last
    (exec.cpp:649-655)."""
    ctxs, qit = collect_query_index_terms(parse_query('"a b" c').root)
    flat = {idx: [t.term for t in v] for idx, v in qit.items()}
    assert flat[0] == ["a"] and flat[1] == ["b"]
    assert qit[0][0].to_next_span == 1  # inner member
    assert max(flat) > 1 and "c" in flat[max(flat)]
    want = jax_qit(jax_parse('"a b" c').root)
    assert _qit(qit) == _qit(want[1]) and _ctxs(ctxs) == _ctxs(want[0])


def test_doc_set_and_veto(ex):
    """VectorIDs analog (docset_iterators.cpp:415-452) and the
    IndexDocumentsFilter pre-veto (matches.h:198-201)."""
    port = ex[0]
    base = port.match_ids("apple")
    assert len(base) >= 3
    subset = base[::2]
    np.testing.assert_array_equal(port.match_ids("apple", doc_set=subset),
                                  subset)
    res = port.search("apple", k=10, doc_set=subset)
    assert res and all(r.doc_id in set(subset.tolist()) for r in res)
    np.testing.assert_array_equal(port.match_ids("apple"), base)

    vetoed = {int(base[0])}
    seen = [m.doc_id for m in both(ex, "apple",
                                   doc_filter=lambda d: d in vetoed)[0]]
    assert vetoed.isdisjoint(seen)
    assert set(seen) == set(int(x) for x in base) - vetoed

    seen2 = [m.doc_id for m in both(ex, "apple", doc_set=subset)[0]]
    assert set(seen2) == set(int(x) for x in subset)
    # the masks are restored after the call
    assert port._deleted is None
    assert [m.doc_id for m in collect(ex, "apple")] == base.tolist()


def test_bulk_materialization_match_heavy():
    """A query matching 20k docs (two windows) delivers full
    MatchedDocuments through one bulk position gather; C grows past the
    candidate cap to the window size."""
    n = 20_000
    exs = pair(*build_pair(lambda s: s.bulk_index(
        list(range(n)), [["common", f"u{d % 97}"] for d in range(n)])))
    got, delivered = both(exs, "common")
    assert delivered == n
    assert [m.doc_id for m in got[:3]] == [0, 1, 2]
    m = got[7]
    assert m.doc_id == 7 and m.term("common").freq == 1
    assert m.term("common").hits[0].pos == 1
    assert m.dws.test("common", 1)


def test_bulk_materialization_phrase_and_filter_parity():
    """The bulk path keeps the exact-phrase re-check and doc_filter."""
    docs = [["red", "shoe", "sale"] if d % 3 == 0 else
            ["shoe", "red", "sale"] if d % 3 == 1 else ["blue", "shoe"]
            for d in range(3000)]
    exs = pair(*build_pair(lambda s: s.bulk_index(list(range(3000)), docs)))
    got = collect(exs, '"red shoe"')
    assert [m.doc_id for m in got] == [d for d in range(3000) if d % 3 == 0]
    got2 = both(exs, '"red shoe"',
                doc_filter=lambda app_id: app_id % 2 == 1)[0]
    assert [m.doc_id for m in got2] == [
        d for d in range(3000) if d % 3 == 0 and d % 2 == 0
    ]
