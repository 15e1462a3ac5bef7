"""The control of the comparison: the reference in bfloat16 put in the program's place.

    python3 benchmark/control.py --workload <name> --seed <n> [--seed <n> ...]

For each seed it draws the cell's sources and pool as a run does, answers
every pool query with the reference computed in bfloat16 (the precision
below the program's float32: weights, scores and their sums), and judges
those answers as a run judges the program's (benchmark/compare.py). It
prints each seed's numbers, one JSON object a line, and needs no program:
the upper readings of PERF.md's limits come from it. A run of the
benchmark never runs it.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if os.path.abspath(sys.path[0] or ".") == BENCH:
    sys.path[0] = ROOT

import torch  # noqa: E402

from benchmark import compare, corpus, harness, querygen  # noqa: E402
from benchmark.reference import Reference  # noqa: E402


def control_numbers(cell, seed: int, device) -> dict:
    """The comparison's numbers for the bfloat16 reference's answers."""
    cfg, traffic = cell.cfg, cell.traffic
    dev = torch.device(device)
    sources = corpus.draw_sources(cfg, seed, dev)
    df = querygen.doc_freq(sources[0], cfg["vocab"], dev)
    pool = querygen.make_pool(traffic, sources[0], df, seed)
    ref = Reference(sources, cfg["vocab"], dev, dtype=torch.bfloat16)
    answers = {}
    for qi, (_, spec) in enumerate(pool):
        _, ids, scores = ref.search(spec, traffic["k"])
        answers[qi] = {tuple(zip(ids.tolist(), scores.tolist()))}
    ref.dtype = torch.float64
    return compare.judge(ref, pool, answers, traffic["k"], 0)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("control: torch.cuda.is_available() is False: no card")
    cell = harness.load_cell(args.workload)
    for seed in args.seed:
        t = time.perf_counter()
        nums = control_numbers(cell, seed, "cuda:0")
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "precision": "bfloat16",
                          "correct": compare.correct(nums),
                          "seconds": time.perf_counter() - t, **nums}),
              flush=True)


if __name__ == "__main__":
    main()
