"""trinity_tpu_torch — the PyTorch/CUDA port of trinity_tpu.

It ports search to torch, with hand-written CUDA kernels for the H100
(``csrc/``): ranked top-k (boolean AND / OR / NOT / k-of-n / OR-of-AND and
exact phrases, BM25 / TF-IDF / Trivial), DocumentsOnly ``match_ids``,
``doc_set`` restriction and block-max pruned search on one segment; a
collection of segment generations (``IndexSourcesCollection``: newer
generations mask the documents they update or erase in older ones,
collection-wide statistics, one merged top-k) and segment merge
(``MergeCandidatesCollection``); segment arrays kept on the card under a
byte budget (``exec/residency.py``); the default rich-match mode
(``exec_rich``: every match with its terms' hits, in docid order),
co-occurrence mining (``query/intersect.py``), query rewriting
(``rewrite_query``) and threaded warmup with a seal on the variants it
ran (``utils/seal.py``). It stands alone: the
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

from trinity_tpu_torch import limits
from trinity_tpu_torch.config import configure, get_config
from trinity_tpu_torch.exec.executor import (
    ExecFlags,
    Executor,
    SearchResult,
    state_from_numpy,
)
from trinity_tpu_torch.exec.richmatch import (
    AbortSearch,
    DocWordsSpace,
    MatchedDocument,
    MatchedTerm,
    TermHit,
    exec_rich,
)
from trinity_tpu_torch.index.builder import SegmentIndexSession
from trinity_tpu_torch.index.format import SegmentData
from trinity_tpu_torch.index.merge import MergeCandidatesCollection, Retention
from trinity_tpu_torch.index.source import IndexSource, IndexSourcesCollection
from trinity_tpu_torch.query.parser import ParserFlags, Query, parse_query
from trinity_tpu_torch.query.rewrite import Alternative, rewrite_query
from trinity_tpu_torch.utils.metrics import get_metrics

__version__ = "0.1.0"


def exec_query(query, source, k=10, scorer="bm25",
               flags=ExecFlags.ACCUMULATED_SCORE_SCHEME, device="cuda"):
    """The reference's exec_query facade (exec.h:50-52): `source` is a
    SegmentData (searched by a new Executor on `device`), an Executor or
    an IndexSourcesCollection. DOCUMENTS_ONLY returns match_ids."""
    if isinstance(source, IndexSourcesCollection):
        if flags & ExecFlags.DOCUMENTS_ONLY:
            return source.match_ids(query)
        return source.search(query, k=k, scorer=scorer)
    ex = source if isinstance(source, Executor) else Executor(source, device)
    if flags & ExecFlags.DOCUMENTS_ONLY:
        return ex.match_ids(query)
    return ex.search(query, k=k, scorer=scorer)


__all__ = [
    "limits",
    "configure",
    "get_config",
    "Executor",
    "ExecFlags",
    "SearchResult",
    "SegmentIndexSession",
    "SegmentData",
    "IndexSource",
    "IndexSourcesCollection",
    "MergeCandidatesCollection",
    "Retention",
    "Query",
    "parse_query",
    "ParserFlags",
    "Alternative",
    "rewrite_query",
    "exec_query",
    "get_metrics",
    "exec_rich",
    "AbortSearch",
    "MatchedDocument",
    "MatchedTerm",
    "TermHit",
    "DocWordsSpace",
    "__version__",
    "state_from_numpy",
]
