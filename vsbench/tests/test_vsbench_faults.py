"""The comparison that decides `correct` has to fail: the control (the
reference in a lower precision in the program's place), and a whole run
with the timed path broken underneath it, once for each fault a cell can
have.  The exchange between chips is not among them: every cell takes one
chip."""

import json
from pathlib import Path

import numpy as np
import pytest

from vsbench import control, run

ROOT = Path(__file__).resolve().parent.parent.parent
TINY = Path(__file__).resolve().parent / "rehearsal" / "tiny.json"
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _index_class(cell):
    from vector_store_tpu_torch.core.index import SlotIndex
    from vector_store_tpu_torch.core.ivf import IvfIndex

    kind = run.resolve(cell, str(TINY))["config"]["index"]["kind"]
    return IvfIndex if kind == "ivf" else SlotIndex


def fault_state_unchanged(monkeypatch, cell):
    """The load step returns slots but leaves the index as it was."""
    monkeypatch.setattr(_index_class(cell), "add",
                        lambda self, v: np.arange(len(np.atleast_2d(v)), dtype=np.int64))


def fault_half_the_batch(monkeypatch, cell):
    """A query batch is searched for its first half only; the rest get the
    first half's answers."""
    from vector_store_tpu_torch.engine.ann_index import AnnIndexBackend

    whole = AnnIndexBackend._run_query_batch

    def half(self, items):
        h = max(1, len(items) // 2)
        out = whole(self, items[:h])
        return out + [out[j % h] for j in range(len(items) - h)]

    monkeypatch.setattr(AnnIndexBackend, "_run_query_batch", half)


def fault_answer_altered(monkeypatch, cell):
    """The index's search returns the next slot in place of its best one."""
    cls = _index_class(cell)
    dispatch = cls.search_dispatch

    def altered(self, queries, k, *a, **kw):
        fetch = dispatch(self, queries, k, *a, **kw)

        def wrong():
            dist, ids = fetch()
            ids = ids.copy()
            ids[:, 0] = (ids[:, 0] + 1) % self.count()
            return dist, ids

        return wrong

    monkeypatch.setattr(cls, "search_dispatch", altered)


FAULTS = [fault_state_unchanged, fault_half_the_batch, fault_answer_altered]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_with_a_fault_underneath_is_not_correct(cell, fault, monkeypatch, capsys):
    fault(monkeypatch, cell)
    rc = run.main(["--workload", cell, "--seed", "4242", "--seconds", "1", "--trace", "0",
                   "--rehearse", str(TINY)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    spec = run.resolve(cell, str(TINY))
    got = control.readings(spec, 2**31 + 5, spec["config"]["control"], "cpu")
    assert got["correct"] is False, got["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(cell, card):
    spec = run.resolve(cell, None)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        got = control.readings(spec, seed, spec["config"]["control"], card)
        assert got["correct"] is False, got["checks"]
