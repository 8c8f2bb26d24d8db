"""The comparison that decides `correct`, and the window's recall.

Set-up loads the rows; `missing_rows` is how many of them the index's
own count lacks once the load was applied (every row is a write that has
to be there).  Every request sent in the window is judged once the window
has closed.
Its answer is due: one that never came, came as an error, or is malformed
(not k distinct keys naming rows, or a distance that is not finite) is a
bad answer.  Of the others the reference says:

  dist_gap    the widest gap, over every key of every answer, between the
              distance the program returned and the reference's float32
              distance from the query to the row the key names: it fails
              a wrong key (the engine's key mapping) and a wrong score
              (the kernels);
  miss_share  1 - recall: the share of the exact top-k that the answers
              missed, over all answers: it fails an index that searches
              the wrong part of the rows (routing, the beam).

The configuration's "limits" object holds the limit of each number
compared; `correct` holds where every one is at or below its limit.
"""

from __future__ import annotations

import numpy as np
import torch


class Judged:
    """The window's good answers as arrays: answer i was to pool query
    qidx[i] and named rows[i] at distances dists[i]; `bad` counts the
    requests left out (no answer, an error, or a malformed one)."""

    def __init__(self, qidx, rows, dists, bad: int) -> None:
        self.qidx = qidx
        self.rows = rows
        self.dists = dists
        self.bad = bad


def collect(records) -> Judged:
    """Arrays of the answered requests of `records` (loop.Records); every
    other request is a bad answer."""
    k = records.k
    state = np.frombuffer(records.state, dtype=np.int8)
    ok = state == records.ANSWERED
    rows = np.frombuffer(records.rows, dtype=np.int64).reshape(-1, k)[ok]
    dists = np.frombuffer(records.dists, dtype=np.float32).reshape(-1, k)[ok]
    qidx = np.frombuffer(records.qi, dtype=np.int64)[ok]
    return Judged(qidx, rows, dists, int((~ok).sum()))


def found_share(rows: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
    """[m] share of each row of `exact` [m, k] present in the same row of
    `rows` [m, k]."""
    hit = (rows[:, :, None] == exact[:, None, :]).any(dim=1)
    return hit.float().mean(dim=1)


def numbers(judged: Judged, exact_rows: torch.Tensor, ref_dists: torch.Tensor) -> dict[str, float]:
    """The numbers compared, and recall.  `exact_rows` [pool, k] is the
    reference's top-k of every pool query; `ref_dists` [m, k] its distance
    for each returned key."""
    out = {"bad_answers": float(judged.bad)}
    m = len(judged.qidx)
    if m == 0:
        # nothing answered: every number at its worst (2 is the widest a
        # cosine distance can be off)
        out.update(dist_gap=2.0, miss_share=1.0, recall=0.0)
        return out
    dev = exact_rows.device
    rows = torch.as_tensor(judged.rows, device=dev)
    got = torch.as_tensor(judged.dists, device=dev)
    out["dist_gap"] = float((got - ref_dists).abs().max())
    shares = torch.cat([
        found_share(rows[o : o + 65_536],
                    exact_rows[torch.as_tensor(judged.qidx[o : o + 65_536], device=dev)])
        for o in range(0, m, 65_536)
    ])
    found = float(shares.double().sum())
    out["recall"] = found / m
    out["miss_share"] = 1.0 - out["recall"]
    return out


def verdict(values: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit, in the order of `limits`."""
    checks = {name: {"value": values[name], "limit": float(limit)} for name, limit in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
