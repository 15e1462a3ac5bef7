"""A cell of the benchmark cut to a size the CPU tests can hold."""

import copy

from benchmark import harness

GENS = [{"update": 448, "new": 64}, {"erase": 64}]


def tiny_cell(name: str = "abstracts1m.mix.batch", docs: int = 8192,
              vocab: int = 8192):
    """`name`'s cell with `docs` documents over `vocab` terms, its
    generations scaled to 1/128 of their size, and df tiers scaled with
    the documents."""
    cell = harness.load_cell(name)
    cell.cfg = dict(cell.cfg, docs=docs, vocab=vocab)
    if cell.cfg["generations"]:
        cell.cfg["generations"] = GENS
    t = copy.deepcopy(cell.traffic)
    t["tiers"] = {"hot": [800, None], "mid": [20, 800], "rare": [2, 20]}
    t["tier_probes"] = 600
    cell.traffic = t
    return cell
