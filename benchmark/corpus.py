"""A configuration's documents, drawn from the seed, and the port's index of them.

The recipe is bench.py's corpus (``_build_corpus_fresh``) and chip_smoke.py's
``build_generations``, frozen here and seeded from ``--seed``: document
lengths uniform in ``doc_len``, tokens from a Zipf law of exponent
``zipf_s`` over ``vocab`` terms named ``w<rank>``. The draw runs on the
device with a ``torch.Generator`` in a few large calls (inverse CDF in
f64), so it takes about a second at a million documents; the token ids
come back to the host for the port's indexer and for the reference.

A configuration's ``generations`` lists the sources after the base one,
oldest first: ``update`` base ids (drawn from the seed without
replacement) get new documents, ``new`` documents take ids from ``docs``
up, ``erase`` further base ids are erased. A source shadows, in every
older source, the ids it updates or erases.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

CHUNK = 1 << 24  # tokens drawn by one call: 128 MiB of f64 uniforms


@dataclass
class Source:
    """One generation: its documents and the app ids it shadows."""

    ids: np.ndarray  # (D,) int64 app ids, ascending
    bounds: np.ndarray  # (D+1,) int64 token offsets
    tokens: np.ndarray  # (bounds[-1],) int32 term ranks
    shadows: np.ndarray  # sorted int64 app ids masked in older sources
    generation: int


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of draws of a run's seed (any
    integer, negative or above 64 bits included)."""
    words = np.random.SeedSequence([int(seed) % (1 << 64), stream])
    a, b = words.generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def zipf_cdf(vocab: int, s: float) -> np.ndarray:
    """P(rank <= r) for ranks 0..vocab-1 of bench.py's Zipf law, f64."""
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** s
    cdf = np.cumsum(p / p.sum())
    cdf[-1] = 1.0
    return cdf


def draw_documents(cfg: dict, n_docs: int, seed: int, stream: int,
                   device) -> tuple:
    """(bounds int64, tokens int32) of `n_docs` documents of `cfg`, drawn
    on `device` from sub_seed(seed, stream)."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    lo, hi = cfg["doc_len"]
    lengths = torch.randint(lo, hi + 1, (n_docs,), generator=g,
                            device=device, dtype=torch.int64)
    bounds = np.zeros(n_docs + 1, np.int64)
    np.cumsum(lengths.cpu().numpy(), out=bounds[1:])
    cdf = torch.from_numpy(zipf_cdf(cfg["vocab"], cfg["zipf_s"])).to(device)
    tokens = np.empty(int(bounds[-1]), np.int32)
    for a in range(0, len(tokens), CHUNK):
        b = min(a + CHUNK, len(tokens))
        u = torch.rand(b - a, generator=g, device=device, dtype=torch.float64)
        r = torch.searchsorted(cdf, u, right=True)
        r = r.clamp_(max=cfg["vocab"] - 1).to(torch.int32)
        tokens[a:b] = r.cpu().numpy()
        del u, r
    return bounds, tokens


def draw_sources(cfg: dict, seed: int, device) -> list:
    """Every source of `cfg`, oldest first (generation 1 is the base)."""
    n = cfg["docs"]
    bounds, tokens = draw_documents(cfg, n, seed, 0, device)
    out = [Source(np.arange(n, dtype=np.int64), bounds, tokens,
                  np.zeros(0, np.int64), 1)]
    gens = cfg["generations"]
    rng = np.random.default_rng(sub_seed(seed, 1))
    picked = rng.choice(n, sum(g.get("update", 0) + g.get("erase", 0)
                               for g in gens), replace=False)
    next_new = n
    for gi, g in enumerate(gens, start=2):
        upd, picked = picked[: g.get("update", 0)], picked[g.get("update", 0):]
        era, picked = picked[: g.get("erase", 0)], picked[g.get("erase", 0):]
        new = np.arange(next_new, next_new + g.get("new", 0))
        next_new += len(new)
        ids = np.sort(np.concatenate([upd, new])).astype(np.int64)
        bounds, tokens = draw_documents(cfg, len(ids), seed, gi, device)
        out.append(Source(ids, bounds, tokens,
                          np.sort(np.concatenate([upd, era])).astype(np.int64),
                          gi))
    return out


def term_names(vocab: int) -> list:
    return [f"w{i}" for i in range(vocab)]


def build_segment(src: Source, names: list):
    """The port's segment of one source: its documents through
    ``SegmentIndexSession.bulk_index_ids``, then ``erase`` of every id it
    shadows (what the port's ``update`` records)."""
    from trinity_tpu_torch import SegmentIndexSession

    sess = SegmentIndexSession()
    if len(src.ids):
        sess.bulk_index_ids(src.ids, src.tokens.astype(np.int64), src.bounds,
                            names)
    for d in src.shadows:
        sess.erase(int(d))
    return sess.commit()


def build_system(sources: list, names: list, device: str):
    """The system under test: an Executor over a lone source, else an
    IndexSourcesCollection of all of them. Returns (system, segments)."""
    from trinity_tpu_torch import Executor, IndexSourcesCollection

    segs = [build_segment(s, names) for s in sources]
    if len(segs) == 1:
        return Executor(segs[0], device=device), segs
    coll = IndexSourcesCollection(device=device)
    for s, seg in zip(sources, segs):
        coll.add_segment(seg, s.generation)
    return coll.commit(), segs
