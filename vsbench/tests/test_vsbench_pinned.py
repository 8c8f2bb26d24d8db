"""The vector cells' corpus, exact reference and judge, held to numbers read
from the harness before a configuration brought its own corpus and
reference: the same seed gives the same bytes, and the same answers the
same numbers."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vsbench import judge, loop, run
from vsbench.drivers.ann_engine import System
from vsbench.references import exact_cosine

ROOT = Path(__file__).resolve().parent.parent.parent
TINY = Path(__file__).resolve().parent / "rehearsal" / "tiny.json"
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

# seed: SHA-256 of the rows, of the pool and of the exact top-10's ids
# (int64), at the rehearsal size on the CPU; both cells share the recipe
PINNED = {
    7: ("b6c610672ba8acf4d45bc68774af4db721fad2f8f1f118bd7c6d0296e59ec17f",
        "40afb8ce359fcaf08aeff3a3a53b81c3c94c4c220c222e644ec425e61bce62a5",
        "f09c0728ab937a92c067d927b838a1e319dc2b36e8472e01d3cf6f9f882e5c87"),
    2**31 + 17: ("9544eacd253a4bdb6bf21ae81355d0f3d73440885564fe814818ffd9895fd295",
                 "4af763afa9d316836a9b06432cdae0b64dbbb09ea15905018d024038bed1ade2",
                 "769dfb8ad4f998290fb3017096599d5764bfd833313d2b13710a9bb5043ac350"),
}


def sha(x) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


@pytest.mark.parametrize("seed", sorted(PINNED))
@pytest.mark.parametrize("cell", CELLS)
def test_a_seed_makes_the_pinned_rows_pool_and_exact_ids(cell, seed):
    spec = run.resolve(cell, str(TINY))
    config, traffic = spec["config"], spec["traffic"]
    corpus = run.load_file(run.HERE / "corpora" / f"{config['corpus']}.py")
    reference = run.load_file(run.HERE / "references" / f"{config['reference']}.py")
    rows, pool = corpus.for_driver(config, traffic, seed, "cpu")
    ref_rows, ref_pool = corpus.for_reference(config, traffic, seed, "cpu")
    exact = reference.exact(ref_rows, ref_pool, int(traffic["limit"]))
    assert (sha(rows), sha(pool), sha(exact.numpy().astype(np.int64))) == PINNED[seed]
    assert (sha(ref_rows.numpy()), sha(ref_pool.numpy())) == PINNED[seed][:2]


# a hand-built set: 12 rows of 4 dims, 4 queries, k 3
ROWS = [[3, 1, 0, 2], [1, 4, 1, 0], [0, 2, 5, 1], [2, 2, 2, 2], [5, 0, 1, 1], [1, 1, 4, 3],
        [4, 3, 0, 1], [0, 0, 1, 6], [2, 5, 3, 0], [1, 3, 0, 4], [6, 1, 2, 0], [0, 4, 4, 4]]
POOL = [[4, 1, 0, 1], [0, 3, 4, 1], [1, 1, 1, 5], [3, 3, 1, 0]]
EXACT = [[4, 0, 6], [2, 11, 8], [7, 9, 5], [6, 8, 1]]
ANSWERS = [  # (pool query, the driver's answer; None: never answered)
    (0, ([(4,), (0,), (6,)], [0.047, 0.055, 0.076])),
    (1, ([(2,), (11,), (3,)], [0.033, 0.094, 0.2])),         # one miss
    (2, ([(7,), (9,), (9,)], [0.037, 0.11, 0.11])),          # a repeated key
    (3, RuntimeError("refused")),
    (3, ([(6,), (8,), (1,)], [0.05, 0.11, 0.13])),
    (0, None),
    (2, ([(7,), (9,), (5,)], [0.037, 0.11, float("nan")])),  # a distance not finite
    (2, ([(7,), (5,), (12,)], [0.037, 0.24, 0.3])),          # a key naming no row
    (1, ([(2,), (11,)], [0.03, 0.09])),                      # fewer than k
]
NUMBERS = {"bad_answers": 6.0, "recall": 0.8888888955116272, "miss_share": 0.1111111044883728,
           "dist_gap": 0.01553545892238617}


def test_the_judge_gives_the_pinned_numbers_on_hand_built_answers():
    rows = torch.tensor(ROWS, dtype=torch.float32)
    pool = torch.tensor(POOL, dtype=torch.float32)
    records = loop.Records(3, lambda a: System.answer_rows(a, 3, len(ROWS)))
    for t, (qi, answer) in enumerate(ANSWERS):
        i = records.open(float(t), qi)
        if answer is not None:
            records.close(i, answer, t + 0.5)
    exact = exact_cosine.exact(rows, pool, 3)
    assert exact.tolist() == EXACT
    judged = judge.collect(records, exact_cosine.SCORES)
    values = judge.numbers(judged, exact)
    values.update(exact_cosine.compared(rows, pool, judged, exact))
    assert values == NUMBERS
