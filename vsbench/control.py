"""The control of a cell's comparison: the reference put in the program's
place, computed in a lower precision than the configuration states.

    python3 -m vsbench.control --workload <cell> --seeds 11 12 13 [--precision int4 ...]

For every query of the cell's pool (the queries a run's clients draw from),
the control answers with the reference's own lower-precision search (its
`lower(items, pool, k, precision)`, over the configuration's corpus made
from the seed); the answers are judged as a run's are (vsbench/judge.py)
against the reference.  One JSON line per seed and precision gives the
numbers beside the configuration's limits; `correct` has to come out
false.  The precisions are the reference's (vsbench/references/exact_cosine.py:
int8, int4, fp8, bf16).

The configuration's "control" names its precision; others may be asked
for.  Not a part of a run: the benchmark's runs never call it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import judge
from .run import HERE, load_file, resolve


def readings(spec: dict, seed: int, precision: str, device: str) -> dict:
    config, traffic = spec["config"], spec["traffic"]
    k = int(traffic["limit"])
    corpus = load_file(HERE / "corpora" / f"{config['corpus']}.py")
    reference = load_file(HERE / "references" / f"{config['reference']}.py")
    items, pool = corpus.for_reference(config, traffic, seed, device)
    exact = reference.exact(items, pool, k)
    got_i, got_d = reference.lower(items, pool, k, precision)
    judged = judge.Judged(np.arange(len(pool)), got_i.cpu().numpy(), got_d.cpu().numpy(), 0)
    values = judge.numbers(judged, exact)
    values.update(reference.compared(items, pool, judged, exact))
    values["missing_rows"] = 0.0  # the control holds every item
    correct, checks = judge.verdict(values, config["limits"])
    return {"workload": spec["cell"]["name"], "seed": seed, "precision": precision,
            "correct": correct, "answers": len(pool), "checks": checks,
            "recall": values["recall"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m vsbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precision", nargs="+", default=None)
    p.add_argument("--rehearse", metavar="JSON", default=None,
                   help="tests only: run on the CPU with the sizes in this file")
    args = p.parse_args(argv)
    spec = resolve(args.workload, args.rehearse)
    if args.rehearse:
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        print("vsbench.control: no CUDA device", file=sys.stderr)
        return 2
    for precision in args.precision or [spec["config"]["control"]]:
        for seed in args.seeds:
            print(json.dumps(readings(spec, seed, precision, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
