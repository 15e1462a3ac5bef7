"""Helpers of the port's tests: one corpus through both packages.

The port keeps its own copies of the JAX package's host modules
(trinity_tpu_torch/index, config, ...). A test corpus is built twice from
the same documents, by each package's SegmentIndexSession, and the two
segments are held equal array by array; each executor then gets its own
package's segment. ``reconfigured`` sets a config knob in both packages.
"""

import contextlib
import dataclasses

import numpy as np

from trinity_tpu import config as ref_config
from trinity_tpu.index.builder import SegmentIndexSession as RefSession
from trinity_tpu_torch import config as port_config
from trinity_tpu_torch.index.builder import SegmentIndexSession as PortSession


def assert_same_segment(got, want):
    """Every SegmentData field equal: arrays by dtype and value, the
    statistics by value."""
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name == "stats":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name


def build_pair(fill, **session_kw):
    """fill(session) indexes documents into a fresh session (made with
    `session_kw`, e.g. track_payloads=True); returns (port segment,
    reference segment), held equal."""
    segs = []
    for cls in (PortSession, RefSession):
        sess = cls(**session_kw)
        fill(sess)
        segs.append(sess.commit())
    assert_same_segment(*segs)
    return tuple(segs)


def bulk_pair(doc_ids, tokens, bounds, names):
    """The bulk_index_ids route through both builders."""
    return build_pair(
        lambda s: s.bulk_index_ids(doc_ids, tokens, bounds, names))


def docs_pair(docs):
    """{doc id: tokens} through begin/insert (positions from 1) in both
    builders."""
    def fill(sess):
        for d, toks in docs.items():
            p = sess.begin(d)
            for pos, t in enumerate(toks, start=1):
                p.insert(t, pos)
            sess.insert(p)
    return build_pair(fill)


@contextlib.contextmanager
def reconfigured(**kw):
    """Set config knobs in both packages for the block, then restore."""
    old = {k: getattr(port_config.get_config(), k) for k in kw}
    for mod in (port_config, ref_config):
        mod.configure(**kw)
    try:
        yield
    finally:
        for mod in (port_config, ref_config):
            mod.configure(**old)
