"""The plain reference: Trinity's ranked retrieval over the drawn tokens, in torch.

It imports nothing of the program and reads nothing the program made: it
indexes the sources' token arrays itself (one stable sort by term), and
evaluates each query spec over every document as dense vectors:

  - a term's frequency in each document, from its token positions;
  - a phrase's frequency: the positions of its first member followed, in
    the same document, by the other members in order;
  - BM25 as Trinity defines it (similarity.h:165-255): a term's or a
    phrase's weight is the sum of ln(1 + (N - df + 0.5) / (df + 0.5)) over
    its member terms, its score weight * f / (f + 1.2) (no length norm);
  - AND, OR, NOT and k-of-n over matches, each node's score the sum of its
    matching children's (the AccumulatedScoreScheme);
  - a collection of generations: N and df summed over every source as it
    was indexed (shadowed documents included, as the collection's
    statistics are), and a document is live unless a newer source updates
    or erases its id;
  - the top k by score descending, then app id ascending.

``dtype`` is the precision of the weights, the scores and their sums:
float64 is the reference; bfloat16 is the control, the reference in the
next precision below the program's float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.querygen import children

K1 = 1.2


class Reference:
    """Every source of a configuration, indexed as one space of documents
    (source after source) on `device`."""

    def __init__(self, sources, vocab: int, device, dtype=torch.float64):
        self.device = torch.device(device)
        self.dtype = dtype
        lengths = np.concatenate([np.diff(s.bounds) for s in sources])
        self.n_docs = len(lengths)
        tok = torch.from_numpy(np.concatenate([s.tokens for s in sources]))
        self.tokens = tok.to(self.device, torch.int64)
        self.doc_of = torch.repeat_interleave(
            torch.arange(self.n_docs, device=self.device),
            torch.from_numpy(lengths).to(self.device))
        sorted_tok, self.order = torch.sort(self.tokens, stable=True)
        starts = torch.arange(vocab + 1, device=self.device)
        self.term_start = torch.searchsorted(sorted_tok, starts).cpu().numpy()
        del sorted_tok
        app = np.concatenate([s.ids for s in sources])
        live = np.ones(self.n_docs, bool)
        off = np.cumsum([0] + [len(s.ids) for s in sources])
        for i, s in enumerate(sources):
            for newer in sources:
                if newer.generation > s.generation and len(newer.shadows):
                    live[off[i]: off[i + 1]] &= ~np.isin(s.ids, newer.shadows)
        self.app = torch.from_numpy(app).to(self.device)
        self.live = torch.from_numpy(live).to(self.device)
        # app id -> its live document (-1 for none)
        self.doc_of_app = torch.full((int(app.max()) + 1,), -1,
                                     dtype=torch.int64, device=self.device)
        live_docs = torch.nonzero(self.live).reshape(-1)
        self.doc_of_app[self.app[live_docs]] = live_docs
        self._postings: dict = {}

    # ------------------------------------------------------------ index
    def postings(self, t: int):
        """(documents ascending, frequencies) of term rank t."""
        if t not in self._postings:
            a, b = self.term_start[t], self.term_start[t + 1]
            docs = self.doc_of[self.order[a:b]]
            self._postings[t] = torch.unique_consecutive(docs,
                                                         return_counts=True)
        return self._postings[t]

    def df(self, t: int) -> int:
        return len(self.postings(t)[0])

    def weight(self, terms) -> float:
        n = self.n_docs
        return sum(math.log(1.0 + (n - self.df(t) + 0.5) / (self.df(t) + 0.5))
                   for t in terms)

    def phrase_freq(self, terms) -> torch.Tensor:
        """(n_docs,) occurrences of the phrase in each document."""
        a, b = self.term_start[terms[0]], self.term_start[terms[0] + 1]
        pos = self.order[a:b]
        ok = torch.ones_like(pos, dtype=torch.bool)
        last = len(self.tokens) - 1
        for j, t in enumerate(terms[1:], start=1):
            nxt = (pos + j).clamp(max=last)
            ok &= ((pos + j <= last) & (self.tokens[nxt] == t)
                   & (self.doc_of[nxt] == self.doc_of[pos]))
        return torch.bincount(self.doc_of[pos[ok]], minlength=self.n_docs)

    # ------------------------------------------------------------ score
    def _leaf(self, terms, freq):
        """(match, score) of a term or phrase with frequencies `freq`."""
        f = freq.to(self.dtype)
        w = torch.tensor(self.weight(terms), dtype=self.dtype,
                         device=self.device)
        match = freq > 0
        return match, torch.where(match, (w * f) / (f + K1),
                                  torch.zeros_like(f))

    def evaluate(self, spec):
        """(match bool, score dtype) over every document, dead ones too."""
        kind = spec[0]
        if kind == "term":
            docs, tf = self.postings(spec[1])
            freq = torch.zeros(self.n_docs, dtype=torch.int64,
                               device=self.device)
            freq[docs] = tf
            return self._leaf((spec[1],), freq)
        if kind == "phrase":
            return self._leaf(spec[1], self.phrase_freq(spec[1]))
        kids = [self.evaluate(c) for c in children(spec)]
        total = kids[0][1]
        for _, s in kids[1:]:
            total = total + s
        if kind == "and":
            match = torch.stack([m for m, _ in kids]).all(0)
        elif kind == "or":
            match = torch.stack([m for m, _ in kids]).any(0)
        elif kind == "not":
            match = kids[0][0] & ~kids[1][0]
            total = kids[0][1]
        elif kind == "some":
            match = torch.stack([m for m, _ in kids]).sum(0) >= spec[1]
        else:
            raise ValueError(kind)
        return match, torch.where(match, total, torch.zeros_like(total))

    def search(self, spec, k: int):
        """(scores over live documents, -inf elsewhere, as f64; top-k app
        ids; their scores in `dtype`, as f64)."""
        match, score = self.evaluate(spec)
        ok = match & self.live
        cand = torch.nonzero(ok).reshape(-1)
        by_app = cand[torch.argsort(self.app[cand], stable=True)]
        top = by_app[torch.argsort(score[by_app], descending=True,
                                   stable=True)[:k]]
        dense = torch.full((self.n_docs,), -math.inf, dtype=torch.float64,
                           device=self.device)
        dense[ok] = score[ok].to(torch.float64)
        return dense, self.app[top], score[top].to(torch.float64)
