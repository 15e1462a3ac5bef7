"""The general query generator: bench.py's ``make_queries``, frozen, driven by
a traffic file and seeded from ``--seed``.

A traffic file (``benchmark/traffic/<name>.json``) lists query classes,
each with its count in a cycle of queries and, for boolean classes, the df
tiers its terms come from (cycled through, one tier list a query). Tiers
are measured on the seed's own base source: terms at ``tier_probes``
log-spaced vocabulary ranks, split by document frequency. Phrases are
runs of distinct adjacent tokens of random documents, as in bench.py.

A query is a pair (text, spec). The text goes to the system; the spec,
the same query as a tree, goes to the reference:

  ("term", t)             one term, rank t (its text is w<t>)
  ("phrase", (t, ...))    an exact phrase
  ("and", (c, ...))       every child matches; score: the sum
  ("or", (c, ...))        some child matches; score: the matched ones' sum
  ("not", c, n)           c matches and n does not; score: c's
  ("some", m, (c, ...))   at least m children match; the matched ones' sum
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.corpus import sub_seed

STREAM = 100  # sub_seed stream of the query draw


def doc_freq(src, vocab: int, device) -> np.ndarray:
    """(vocab,) documents containing each term rank in one source."""
    tok = torch.from_numpy(src.tokens).to(device, torch.int64)
    lengths = torch.from_numpy(np.diff(src.bounds)).to(device)
    doc = torch.repeat_interleave(torch.arange(len(lengths), device=device),
                                  lengths)
    pairs = torch.unique(doc * vocab + tok)
    df = torch.bincount(pairs % vocab, minlength=vocab)
    return df.cpu().numpy().astype(np.int64)


def tier_pools(traffic: dict, df: np.ndarray) -> dict:
    """{tier: term ranks}: probed ranks whose df lies in [lo, hi)."""
    vocab = len(df)
    cand = np.unique(np.geomspace(1, vocab, traffic["tier_probes"])
                     .astype(np.int64)) - 1
    out = {}
    for name, (lo, hi) in traffic["tiers"].items():
        d = df[cand]
        sel = (d >= lo) & (d < (hi if hi is not None else np.inf))
        out[name] = cand[sel]
    return out


def render(spec) -> str:
    """The query language text of a spec."""
    kind = spec[0]
    if kind == "term":
        return f"w{spec[1]}"
    if kind == "phrase":
        return '"' + " ".join(f"w{t}" for t in spec[1]) + '"'
    if kind == "and":
        return " ".join(render(c) for c in spec[1])
    if kind == "or":
        return " OR ".join(f"({render(c)})" if c[0] == "and" else render(c)
                           for c in spec[1])
    if kind == "not":
        return f"{render(spec[1])} NOT {render(spec[2])}"
    if kind == "some":
        return "[" + ",".join(render(c) for c in spec[2]) + f"]/{spec[1]}"
    raise ValueError(kind)


def cycle(traffic: dict) -> list:
    """One cycle of the mix: each class as often as its per_cycle."""
    return [c for c in traffic["classes"] for _ in range(c["per_cycle"])]


def make_pool(traffic: dict, src, df: np.ndarray, seed: int) -> list:
    """pool_batches x batch distinct queries [(text, spec)] of the base
    source `src` (its df), in batch order."""
    cyc = cycle(traffic)
    if traffic["batch"] % len(cyc):
        raise ValueError(f"batch {traffic['batch']} is not a multiple of "
                         f"the cycle's {len(cyc)} queries")
    pools = tier_pools(traffic, df)
    for c in traffic["classes"]:
        for tiers in c.get("tiers", ()):
            for t in set(tiers):
                if len(pools[t]) < tiers.count(t) + 1:
                    raise ValueError(f"tier {t!r} has {len(pools[t])} terms")
    rng = np.random.default_rng(sub_seed(seed, STREAM))
    bounds, tokens = src.bounds, src.tokens

    def picks(tiers):
        out = []
        for t in tiers:
            pool = pools[t]
            r = int(pool[rng.integers(0, len(pool))])
            while r in out:
                r = int(pool[rng.integers(0, len(pool))])
            out.append(r)
        return out

    def ngram(width):
        while True:
            d = int(rng.integers(0, len(bounds) - 1))
            b, e = bounds[d], bounds[d + 1]
            if e - b < width:
                continue
            i = int(rng.integers(b, e - width + 1))
            run = [int(t) for t in tokens[i: i + width]]
            if len(set(run)) == width:
                return run

    def draw(c, seen):
        node = c["node"]
        if node == "phrase":
            return ("phrase", tuple(ngram(c["width"])))
        tiers = c["tiers"][seen % len(c["tiers"])]
        ts = [("term", t) for t in picks(tiers)]
        if node in ("and", "or"):
            return (node, tuple(ts))
        if node == "not":
            pos = ts[0] if len(ts) == 2 else ("and", tuple(ts[:-1]))
            return ("not", pos, ts[-1])
        if node == "some":
            return ("some", c["min"], tuple(ts))
        if node == "or_of_and":
            h = len(ts) // 2
            return ("or", (("and", tuple(ts[:h])), ("and", tuple(ts[h:]))))
        raise ValueError(node)

    out, texts, seen = [], set(), {}
    n = traffic["pool_batches"] * traffic["batch"]
    for i in range(n):
        c = cyc[i % len(cyc)]
        for _ in range(1000):
            spec = draw(c, seen.get(c["name"], 0))
            text = render(spec)
            if text not in texts:
                break
        else:
            raise RuntimeError(f"no distinct {c['name']} query in 1000 draws")
        seen[c["name"]] = seen.get(c["name"], 0) + 1
        texts.add(text)
        out.append((text, spec))
    return out


def batches(traffic: dict, pool: list) -> list:
    b = traffic["batch"]
    return [pool[i: i + b] for i in range(0, len(pool), b)]


def children(spec) -> tuple:
    """The sub-queries of a spec (none for a term or a phrase)."""
    kind = spec[0]
    if kind in ("and", "or"):
        return spec[1]
    if kind == "not":
        return spec[1:]
    if kind == "some":
        return spec[2]
    return ()


def spec_terms(spec) -> tuple:
    """(every term rank of a spec, the ranks inside its phrases)."""
    if spec[0] == "term":
        return {spec[1]}, set()
    if spec[0] == "phrase":
        return set(spec[1]), set(spec[1])
    terms, phr = set(), set()
    for c in children(spec):
        a, b = spec_terms(c)
        terms |= a
        phr |= b
    return terms, phr
