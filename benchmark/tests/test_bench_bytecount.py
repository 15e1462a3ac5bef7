"""The frozen least-bytes count behind kernels_roofline.batch."""

import numpy as np
import pytest

from benchmark import bytecount, corpus
from benchmark.tests.tiny import tiny_cell

K = 10
T = lambda t: ("term", t)  # noqa: E731


@pytest.fixture(scope="module")
def seg():
    cell = tiny_cell(docs=2048, vocab=2048)
    src = corpus.draw_sources(cell.cfg, 5, "cpu")[0]
    return corpus.build_segment(src, corpus.term_names(2048))


def by_hand(seg, t, phrase=False):
    """A term's bytes, block by block."""
    tid = seg.term_id(f"w{t}")
    a, n = int(seg.term_block_start[tid]), int(seg.term_nblocks[tid])
    total = 0
    for b in range(a, a + n):
        total += 32 + 128 * (int(seg.block_bits_doc[b])
                             + int(seg.block_bits_freq[b])) // 8
    if phrase:
        first = int(seg.block_hits_off[a])
        last = first + int(seg.term_sum_hits[tid]) - 1
        rows = (seg.hit_group_off[last // 128 + 1]
                - seg.hit_group_off[first // 128])
        total += int(rows) * 128 * 4
    return total


def test_term_bytes_follow_the_layout(seg):
    for t in (0, 1, 5, 40, 300):
        tid = seg.term_id(f"w{t}")
        assert tid >= 0
        assert bytecount.term_bytes(seg, tid, False) == by_hand(seg, t)
        assert bytecount.term_bytes(seg, tid, True) == by_hand(seg, t, True)
        assert by_hand(seg, t, True) > by_hand(seg, t)
    # the hottest term's posting list spans many blocks
    assert int(seg.term_nblocks[seg.term_id("w0")]) > 8


def test_a_term_shared_by_two_queries_counts_once(seg):
    q1 = ("and", (T(0), T(40)))
    q2 = ("or", (T(0), T(300), T(5)))
    one = bytecount.batch_bytes([seg], [q1], K)
    both = bytecount.batch_bytes([seg], [q1, q2], K)
    assert one == by_hand(seg, 0) + by_hand(seg, 40) + K * 8
    assert both == (by_hand(seg, 0) + by_hand(seg, 40) + by_hand(seg, 300)
                    + by_hand(seg, 5) + 2 * K * 8)


def test_phrase_members_add_their_positions(seg):
    q = ("phrase", (0, 1))
    assert bytecount.batch_bytes([seg], [q], K) == (
        by_hand(seg, 0, True) + by_hand(seg, 1, True) + K * 8)
    # a term both inside and outside a phrase reads its positions once
    q2 = ("and", (T(1), T(40)))
    assert bytecount.batch_bytes([seg], [q, q2], K) == (
        by_hand(seg, 0, True) + by_hand(seg, 1, True) + by_hand(seg, 40)
        + 2 * K * 8)


def test_every_source_counts_and_unknown_terms_none(seg):
    q = ("and", (T(0), T(40)))
    assert bytecount.batch_bytes([seg, seg], [q], K) == (
        2 * (by_hand(seg, 0) + by_hand(seg, 40)) + K * 8)
    assert bytecount.batch_bytes([seg], [T(10**7)], K) == K * 8
    assert np.isclose(bytecount.H100_BYTES_PER_S, 3.35e12)
