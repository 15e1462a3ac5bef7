"""trinity_tpu_torch — the PyTorch/CUDA port of trinity_tpu.

It ports ranked search on one segment (boolean AND / OR / NOT / k-of-n /
OR-of-AND and exact phrases, BM25 / TF-IDF / Trivial top-k) to torch, with
hand-written CUDA kernels for the H100 (``csrc/``). It stands alone: the
host code — config, indexing and the segment format, the query language,
plan compilation, weights — is the port's own copy of the JAX package's
JAX-free modules, in the same layout (``config.py``, ``index/``,
``query/``, ``plan/``, ``utils/bitpack.py``, ``utils/native.py``), and
nothing here imports ``trinity_tpu`` or JAX. ``configure`` sets the port's
own config.

Quick start::

    from trinity_tpu_torch import Executor, SegmentIndexSession

    sess = SegmentIndexSession()
    proxy = sess.begin(doc_id=1)
    for pos, token in enumerate("hello brave new world".split(), start=1):
        proxy.insert(token, pos)
    sess.insert(proxy)
    ex = Executor(sess.commit(), device="cuda")  # or "cpu"
    for hit in ex.search('"brave new" OR world', k=10):
        print(hit.doc_id, hit.score)
"""

from trinity_tpu_torch.config import configure, get_config
from trinity_tpu_torch.index.builder import SegmentIndexSession
from trinity_tpu_torch.index.format import SegmentData
from trinity_tpu_torch.query.parser import parse_query
from trinity_tpu_torch.exec.executor import (
    Executor,
    SearchResult,
    state_from_numpy,
)

__all__ = [
    "Executor",
    "SearchResult",
    "SegmentData",
    "SegmentIndexSession",
    "configure",
    "get_config",
    "parse_query",
    "state_from_numpy",
]
