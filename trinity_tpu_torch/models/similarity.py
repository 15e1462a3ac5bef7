"""Similarity models: BM25, TF-IDF, Trivial — the port's own.

The host half (``Similarity``, ``BM25``, ``TFIDF``, ``Trivial``,
``SIMILARITIES``: per-term f64 weights and the f32 scalar scorers the
numpy host routes use) is a copy of ``trinity_tpu/models/similarity.py``
lines 23-105, whose ``_sqrt`` sent any non-numpy input to
``jax.numpy.sqrt``; here a torch tensor goes to ``ieee_sqrt``.

The device half is ``score_tile(scorer_name, freq, weight)`` on torch
tensors, with the same f32 operation order — the parity contract with
``trinity_tpu/oracle.py``:

  bm25     (w * f) / (f + K1)
  tfidf    sqrt(f) * w
  trivial  f

``SCORER_CODE`` is the scorer id the CUDA kernels take (csrc/decode.cuh
``score_tile`` applies the same formulas in round-to-nearest intrinsics).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


class Similarity:
    """Base: subclass and register in SIMILARITIES (the analog of
    subclassing IndexSourcesCollectionTermsScorer, similarity.h:43-53)."""

    name: str = "?"

    @staticmethod
    def weight(dfs: Sequence[int], docs_cnt: int) -> float:
        """Per-(term|phrase) weight from member-term document frequencies,
        aggregated across the collection (similarity.h:209-217). f64."""
        raise NotImplementedError

    @staticmethod
    def score_tile(freq, weight):
        """Device: f32 score from f32 freq tile and f32 weight (broadcast)."""
        raise NotImplementedError

    @classmethod
    def host_score(cls, freq: int, weight: float) -> np.float32:
        """Oracle path: identical f32 op order on scalars."""
        return cls.score_tile(np.float32(freq), np.float32(weight))


class BM25(Similarity):
    """similarity.h:165-255: idf = ln(1 + (N - df + .5)/(df + .5)) summed
    over member terms; score = idf * freq / (freq + k1); k1 = 1.2 and the
    norm is fixed at k1 (`const auto norm{k1}`, similarity.h:230 — no
    document-length normalization)."""

    name = "bm25"
    K1 = np.float32(1.2)

    @staticmethod
    def weight(dfs, docs_cnt):
        return sum(
            math.log(1.0 + (docs_cnt - df + 0.5) / (df + 0.5)) for df in dfs
        )

    @staticmethod
    def score_tile(freq, weight):
        return (weight * freq) / (freq + BM25.K1)


class TFIDF(Similarity):
    """similarity.h:75-163: idf = ln((N+1)/(df+1)) + 1 summed over member
    terms; score = sqrt(freq) * idf."""

    name = "tfidf"

    @staticmethod
    def weight(dfs, docs_cnt):
        return sum(math.log((docs_cnt + 1) / float(df + 1)) + 1.0 for df in dfs)

    @staticmethod
    def score_tile(freq, weight):
        return _sqrt(freq) * weight


class Trivial(Similarity):
    """similarity.h:56-72: score = freq."""

    name = "trivial"

    @staticmethod
    def weight(dfs, docs_cnt):
        return 0.0

    @staticmethod
    def score_tile(freq, weight):
        return freq


def _sqrt(x):
    """f32 sqrt for host scalars and arrays (np.sqrt) and torch tensors
    (ieee_sqrt): both IEEE-rounded, so oracle and engine agree exactly."""
    if isinstance(x, torch.Tensor):
        return ieee_sqrt(x)
    return np.sqrt(x)


SIMILARITIES = {c.name: c for c in (BM25, TFIDF, Trivial)}

SCORER_CODE = {"bm25": 0, "tfidf": 1, "trivial": 2}


def _bm25(freq, weight):
    return (weight * freq) / (freq + float(BM25.K1))


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt of a non-negative f32 tensor.

    torch's CPU sqrt goes through MKL's vector math, which is not correctly
    rounded (1 ulp off on about 0.5% of inputs), while the oracle's
    np.sqrt and the kernels' __fsqrt_rn are. Three Newton steps in f64
    from torch's estimate (any start within 1e-3 reaches f64 precision)
    and one rounding to f32 give the IEEE result: the sqrt of an f32 never
    lies within 2^-49 of an f32 rounding boundary."""
    x64 = x.double()
    y = torch.sqrt(x).double()
    y = torch.where(y > 0, y, 1.0)
    for _ in range(3):
        y = 0.5 * (y + x64 / y)
    return torch.where(x > 0, y.float(), x)


def _tfidf(freq, weight):
    return ieee_sqrt(freq) * weight


def _trivial(freq, weight):
    return freq


_SCORE_TILE = {"bm25": _bm25, "tfidf": _tfidf, "trivial": _trivial}


def score_tile(scorer_name: str, freq: torch.Tensor, weight) -> torch.Tensor:
    """f32 score of an f32 freq tensor under `scorer_name` (weight a float
    or a broadcastable f32 tensor)."""
    return _SCORE_TILE[scorer_name](freq, weight)


__all__ = ["BM25", "SCORER_CODE", "SIMILARITIES", "Similarity", "TFIDF",
           "Trivial", "ieee_sqrt", "score_tile"]
