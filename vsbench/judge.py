"""The comparison that decides `correct`, and the window's recall: what
holds for any top-k search.

Set-up loads the items; `missing_rows` is how many of them the system's
own count lacks once the load was applied (every item is a write that has
to be there).  Every request sent in the window is judged once the window
has closed.  Its answer is due: one that never came, came as an error, or
is malformed (the driver's `answer_rows` says which) is a bad answer, and
so is one whose keys lack the scores that the configuration's reference
needs.  Of the others:

  miss_share  1 - recall: recall is the mean, over the answers whose exact
              top-k holds at least one item, of the share of those items
              the answer named; a -1 pad of the exact list (fewer than k
              items qualify) is neither found nor missed.  It fails an
              index that searches the wrong part of the items (routing,
              the beam).

The configuration's reference (vsbench/references/<name>.py) gives the
exact top-k and the numbers compared that are its own.  A reference module
has

    SCORES                          True where its numbers read the score
                                    of every answered key
    exact(items, pool, k)           [pool, k] item ids of every query's
                                    exact top-k, best first, padded with -1
    compared(items, pool, judged, exact)
                                    {name: value} of its own numbers over
                                    the judged answers

The configuration's "limits" object holds the limit of each number
compared; `correct` holds where every one is at or below its limit.
"""

from __future__ import annotations

import numpy as np
import torch

# answers compared a block at a time: [block, k, k] booleans
BLOCK = 65_536


class Judged:
    """The window's good answers as arrays: answer i was to pool query
    qidx[i] and named the items ids[i] (padded with -1) with the scores
    scores[i] (NaN where none was given); `bad` counts the requests left
    out (no answer, an error, a malformed one, or one without the scores
    the reference needs)."""

    def __init__(self, qidx, ids, scores, bad: int) -> None:
        self.qidx = qidx
        self.ids = ids
        self.scores = scores
        self.bad = bad


def collect(records, scores: bool) -> Judged:
    """Arrays of the answered requests of `records` (loop.Records); every
    other request is a bad answer, as is one where `scores` is asked for
    and a named item has none."""
    k = records.k
    ok = np.frombuffer(records.state, dtype=np.int8) == records.ANSWERED
    ids = np.frombuffer(records.ids, dtype=np.int64).reshape(-1, k)
    given = np.frombuffer(records.scores, dtype=np.float32).reshape(-1, k)
    if scores:
        ok &= ~(np.isnan(given) & (ids >= 0)).any(axis=1)
    qidx = np.frombuffer(records.qi, dtype=np.int64)[ok]
    return Judged(qidx, ids[ok], given[ok], int((~ok).sum()))


def found_due(ids: torch.Tensor, exact: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """([m] items of each row of `exact` [m, k] named in the same row of
    `ids` [m, k], [m] items in that row of `exact`); -1 pads count in
    neither."""
    due = exact >= 0
    hit = (ids[:, :, None] == exact[:, None, :]).any(dim=1) & due
    return hit.sum(dim=1), due.sum(dim=1)


def numbers(judged: Judged, exact: torch.Tensor) -> dict[str, float]:
    """bad_answers, recall and miss_share.  `exact` [pool, k] is the
    reference's top-k of every pool query."""
    out = {"bad_answers": float(judged.bad)}
    m = len(judged.qidx)
    if m == 0:
        out.update(miss_share=1.0, recall=0.0)
        return out
    exact = torch.as_tensor(exact, dtype=torch.long)
    dev = exact.device
    ids = torch.as_tensor(judged.ids, device=dev)
    found, due = map(torch.cat, zip(*(
        found_due(ids[o : o + BLOCK], exact[torch.as_tensor(judged.qidx[o : o + BLOCK], device=dev)])
        for o in range(0, m, BLOCK))))
    some = due > 0
    shares = found[some].float() / due[some].float()
    # every answer whose exact list is empty has nothing to miss
    out["recall"] = float(shares.double().sum()) / len(shares) if len(shares) else 1.0
    out["miss_share"] = 1.0 - out["recall"]
    return out


def verdict(values: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit, in the order of `limits`."""
    checks = {name: {"value": values[name], "limit": float(limit)} for name, limit in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
