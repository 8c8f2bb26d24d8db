"""Whole runs of each cell on the CPU, through the rehearsal switch (a tiny
test-only size), each as its own process; and the runs that must fail."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
TINY = Path(__file__).resolve().parent / "rehearsal" / "tiny.json"
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def run(args, cwd=ROOT, timeout=240):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "-m", "vsbench.run", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def last_line(proc):
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-1]) if lines else None


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("rep", range(3))
@pytest.mark.parametrize("cell", CELLS)
def test_a_rehearsal_run_ends_with_one_well_formed_line(cell, rep, trace):
    proc = run(["--workload", cell, "--seed", str(2**31 + 17 + rep), "--seconds", "1",
                "--trace", str(trace), "--rehearse", str(TINY)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = last_line(proc)
    assert sum(1 for ln in proc.stdout.splitlines() if ln.startswith("{")) == 1
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0, out
    for check in out["checks"].values():
        assert set(check) == {"value", "limit"}
    assert proc.stderr.strip().splitlines()[-len(out["checks"]):] == [
        f"check {n} {c['value']!r} limit {c['limit']!r}" for n, c in out["checks"].items()
    ], proc.stderr[-2000:]
    want = BENCH["per_layer" if trace else "end_to_end"]
    names = {m["name"] for m in want if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) <= names
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(out["metrics"]) == names
    else:
        assert set(out["metrics"]) == names
        assert all(m["value"] > 0 for m in out["metrics"].values()), out["metrics"]
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert proc.returncode != 0
    assert last_line(proc) is None
    assert "CUDA device" in proc.stderr


def test_a_run_with_only_the_benchmark_files_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "vsbench", tmp_path / "vsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0",
                "--rehearse", str(TINY)], cwd=tmp_path)
    assert proc.returncode != 0
    assert last_line(proc) is None
    assert "vector_store_tpu_torch" in proc.stderr


@pytest.mark.parametrize("burst", [None, {"every_s": 0.5, "for_s": 0.1, "times": 4}])
def test_an_open_loop_is_a_traffic_file_away(tmp_path, burst):
    """A traffic file that names the open loop runs a cell as data alone."""
    tiny = json.loads(TINY.read_text())
    tiny["traffic"].update({"loop": "open", "rate": 400, "burst": burst})
    if burst is None:
        del tiny["traffic"]["burst"]
    over = tmp_path / "open.json"
    over.write_text(json.dumps(tiny))
    proc = run(["--workload", CELLS[0], "--seed", str(2**31 + 99), "--seconds", "2",
                "--trace", "0", "--rehearse", str(over)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = last_line(proc)
    assert out["correct"] is True and out["failed"] == 0, out
    # Poisson arrivals at 400 a second (the burst adds 4 x 0.2 of the time)
    want = 400 * 2 * (1.6 if burst else 1.0)
    assert 0.7 * want < out["attempted"] < 1.3 * want, out["attempted"]
