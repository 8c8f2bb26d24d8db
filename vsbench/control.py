"""The control of a cell's comparison: the reference put in the program's
place, computed in a lower precision than the configuration states.

    python3 -m vsbench.control --workload <cell> --seeds 11 12 13 [--precision int4 ...]

For every query of the cell's pool (the queries a run's clients draw from),
the control answers with the exact top-k over the rows stored in that
precision, with the distances it computed there; the answers are judged
as a run's are (vsbench/judge.py) against the float32 reference.  One JSON
line per seed and precision gives the numbers beside the configuration's
limits; `correct` has to come out false.  The precisions:

    int8, int4  per-row symmetric codes of the normalised rows,
                scale = max|x| / 127 (or 7), as the program's int8 rows
    fp8         float8 e4m3 of the normalised rows, scaled per row so that
                the largest element is 448
    bf16        the rows rounded to bfloat16 (what the graph stores)

The configuration's "control" names its precision; others may be asked
for.  Not a part of a run: the benchmark's runs never call it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import data, judge
from .run import HERE, load_file, resolve

LEVELS = {"int8": 127.0, "int4": 7.0}


def store(x: torch.Tensor, precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(values as float32, scale [n]) of normalised rows x in `precision`:
    a row reads scale * values."""
    if precision == "bf16":
        return x.to(torch.bfloat16).float(), torch.ones(len(x), device=x.device)
    absmax = torch.clamp(x.abs().amax(dim=1), min=1e-12)
    if precision == "fp8":
        scale = absmax / 448.0
        return (x / scale[:, None]).to(torch.float8_e4m3fn).float(), scale
    levels = LEVELS[precision]
    scale = absmax / levels
    return torch.clamp(torch.round(x / scale[:, None]), -levels, levels), scale


def answers(reference, rows: torch.Tensor, pool: torch.Tensor, k: int,
            precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(row indices [pool, k], distances [pool, k]): the exact top-k of every
    pool query over the rows stored in `precision`."""
    q = reference.normalize(pool)
    best_d = torch.full((len(q), k), float("inf"), device=q.device)
    best_i = torch.full((len(q), k), -1, dtype=torch.long, device=q.device)
    for off in range(0, len(rows), reference.BLOCK):
        vals, scale = store(reference.normalize(rows[off : off + reference.BLOCK]), precision)
        d = 1.0 - (q @ vals.T) * scale[None, :]
        bd, bi = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False, sorted=True)
        cat_d, cat_i = torch.cat([best_d, bd], 1), torch.cat([best_i, bi + off], 1)
        order = torch.sort(cat_d, dim=1, stable=True)[1][:, :k]
        best_d, best_i = torch.gather(cat_d, 1, order), torch.gather(cat_i, 1, order)
    return best_i, best_d


def readings(spec: dict, seed: int, precision: str, device: str) -> dict:
    config, traffic = spec["config"], spec["traffic"]
    n, d = int(config["rows"]), int(config["index"]["dimensions"])
    k = int(traffic["limit"])
    reference = load_file(HERE / "references" / f"{config['reference']}.py")
    rows = data.rows_on(config["data"], n, d, seed, device)
    idx, noise = data.pool_draw(n, d, int(traffic["pool"]), seed, device)
    pool = data.pool_from(rows[idx], noise, float(traffic["query_noise"]))
    _, exact = reference.topk(rows, pool, k)
    got_i, got_d = answers(reference, rows, pool, k, precision)
    qidx = torch.arange(len(pool), device=device)
    ref_d = reference.pair_distances(rows, pool, qidx, got_i)
    judged = judge.Judged(qidx.cpu().numpy(), got_i.cpu().numpy(), got_d.cpu().numpy(), 0)
    values = judge.numbers(judged, exact, ref_d)
    values["missing_rows"] = 0.0  # the control holds every row
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
