"""Run one cell of the benchmark and print its result as the last line.

    python3 -m vsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of BENCHMARK.json's "workloads") names a configuration
(vsbench/configs/<name>.json) and a traffic mix (vsbench/traffic/<name>.json).
A run:

  1. makes the items and the query pool from the seed, on the card (the
     configuration's "corpus", vsbench/corpora/<name>.py);
  2. starts the system under test (the configuration's "driver",
     vsbench/drivers/<name>.py) and loads the items into it, timing the
     load;
  3. warms up: every client sends `warmup_rounds` requests;
  4. measures for --seconds: the clients of the traffic mix send queries
     until the window closes; with --trace 1 a profiler covers one bounded
     slice in the middle of the window;
  5. waits for the answers still due, reduces the slice, reads the device's
     memory peak, closes the system and synchronises the device;
  6. judges every request of the window against the plain reference (the
     configuration's "reference", vsbench/references/<name>.py), on the
     items and pool made again from the seed (vsbench/judge.py);
  7. prints one JSON line: correct, attempted, failed, metrics, device
     (and, traced, the breakdown), how the window served (rate, tail,
     batch size; no bound holds them), and last the numbers compared with
     their limits; the same numbers end its standard error.

It exits non-zero and prints no result where no card is found, or where
jax, jaxlib, flax or the JAX package were loaded in the process.  The
--rehearse switch, for the tests alone, runs on the CPU with the sizes of
a JSON file laid over the configuration's and the traffic's.
"""

from __future__ import annotations

import argparse
import asyncio
import faulthandler
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vector_store_tpu")
# seconds the answers still due when the window closes may take
WAIT_S = 60.0
# seconds the warm-up's requests may take: the first run in a checkout
# builds the program's kernels at its first query (about a minute on the
# card's host), and a run may take 1,200 s in all
WARM_WAIT_S = 900.0


def process_seconds() -> float:
    """Seconds since this process started (Linux /proc; 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class GcClock:
    """Time spent in the interpreter's garbage collections (any thread)."""

    def __init__(self) -> None:
        self.count, self.total_s, self.longest_s = 0, 0.0, 0.0
        self._t = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            took = time.perf_counter() - self._t
            self.count += 1
            self.total_s += took
            self.longest_s = max(self.longest_s, took)
            self._t = None


def load_file(path: Path):
    spec = importlib.util.spec_from_file_location(f"vsbench_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(name: str, rehearse: str | None) -> dict:
    """Everything BENCHMARK.json and the cell's files say about cell `name`."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    if rehearse:
        over = json.loads(Path(rehearse).read_text())
        config.update(over.get("config", {}))
        traffic.update(over.get("traffic", {}))

    def mine(metric):
        return name in metric.get("workloads", [name])

    return {
        "cell": cell,
        "config": config,
        "traffic": traffic,
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


async def measure(spec: dict, seed: int, seconds: float, traced: bool, device: str) -> dict:
    import numpy as np
    import torch

    from . import judge, loop, trace
    from .reading import Reading

    config, traffic = spec["config"], spec["traffic"]
    clients_of = loop.kind(traffic)
    k = int(traffic["limit"])
    on_device = device != "cpu"

    # 1. items and pool from the seed
    corpus = load_file(HERE / "corpora" / f"{config['corpus']}.py")
    items, pool = corpus.for_driver(config, traffic, seed, device)
    n = len(items)

    # 2. the system under test
    driver = load_file(HERE / "drivers" / f"{config['driver']}.py")
    batch = driver.BATCH_COUNTERS  # {"queries", "batches", "seconds"} or None
    system = driver.System(config, device)
    await system.start(items)
    missing_rows = n - system.loaded
    load_s = system.load_s
    del items

    async def ask(qi):
        return await system.ask(pool[qi], k)

    def answer_rows(answer):
        return driver.System.answer_rows(answer, k, n)

    # 3. warm-up: the cell's own batch shapes, through the same entry
    warm = loop.Records(k, answer_rows)
    gate = loop.Gate()
    t_warm = time.perf_counter()
    if await loop.finish(clients_of.start(ask, traffic, seed + 1, warm, gate,
                                           rounds=int(traffic["warmup_rounds"])), WARM_WAIT_S):
        raise RuntimeError(f"the warm-up's requests were not answered in {WARM_WAIT_S:.0f} s")
    print(f"vsbench: set-up: load {load_s:.2f} s, warm-up {time.perf_counter() - t_warm:.2f} s",
          file=sys.stderr, flush=True)
    if traced:
        trace.warm_profiler(on_device)

    # 4. the window
    setup_s = process_seconds()
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    t_end = t0 + seconds
    before = system.counters()
    reqs = loop.Records(k, answer_rows)
    clients = clients_of.start(ask, traffic, seed, reqs, gate, t_end=t_end)
    the_slice = trace.Slice(on_device) if traced else None
    edges = {}
    if traced:
        # the profiler starts and stops while no request is in flight
        s_at, s_len = trace.slice_edges(seconds)
        await asyncio.sleep(max(0.0, t0 + s_at - time.perf_counter()))
        await gate.hold()
        edges["start"] = system.counters()
        the_slice.start()
        gate.release()
        await asyncio.sleep(max(0.0, t0 + s_at + s_len - time.perf_counter()))
        await gate.hold()
        the_slice.stop()
        edges["stop"] = system.counters()
        gate.release()
    await asyncio.sleep(max(0.0, t_end - time.perf_counter()))
    cpu_s = time.process_time() - cpu0
    after = system.counters()

    # 5. answers still due, the slice, the memory peak; the system closed
    gave_up = await loop.finish(clients, WAIT_S)
    t_wait = time.perf_counter()
    gc.callbacks.remove(gc_clock)
    if traced:
        the_slice.collect()
    peak = torch.cuda.max_memory_allocated() if on_device else 0
    await system.close()
    if on_device:
        torch.cuda.synchronize()
    del system, ask
    gc.collect()
    if on_device:
        torch.cuda.empty_cache()

    # 6. the reference, on the items and pool made again from the seed
    reference = load_file(HERE / "references" / f"{config['reference']}.py")
    ref_items, ref_pool = corpus.for_reference(config, traffic, seed, device)
    exact = reference.exact(ref_items, ref_pool, k)
    judged = judge.collect(reqs, reference.SCORES)
    values = judge.numbers(judged, exact)
    values.update(reference.compared(ref_items, ref_pool, judged, exact))
    values["missing_rows"] = float(missing_rows)
    correct, checks = judge.verdict(values, config["limits"])
    del ref_items, ref_pool, exact

    # 7. the numbers of the line
    attempted = len(reqs)
    ok = np.frombuffer(reqs.state, dtype=np.int8) == reqs.ANSWERED
    done = np.frombuffer(reqs.done, dtype=np.float64)
    failed = attempted - int(ok.sum())
    in_window = int((ok & (done <= t_end)).sum())
    # a request that failed or was never answered waited until the wait ended
    lat = (np.where(ok, done, t_wait) - np.frombuffer(reqs.sent, dtype=np.float64)) * 1e3
    e2e = {"recall": values["recall"], "setup_s": setup_s}
    dev = {
        "platform": "gpu" if on_device else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_device else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed}
    if traced:
        reading = Reading((before, after), (edges["start"], edges["stop"]), the_slice, on_device,
                          load=(n, load_s), batches=batch and batch["batches"])
        metrics = {}
        for m in spec["per_layer"]:
            value = load_file(HERE / "metrics" / f"{m['name']}.py").read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        out["metrics"] = metrics
        dev["busy_s"] = reading.busy_s
        dev["window_s"] = reading.slice_s
        out["device"] = dev
        out["breakdown"] = {
            "device_ops": trace.top_ops(reading.ops),
            "idle_gaps": trace.idle_gaps(reading.ops, the_slice.events,
                                         the_slice.start_ns, the_slice.stop_ns),
        }
        out["trace"] = {"events": len(the_slice.events), "device_ops": len(reading.ops)}
    else:
        out["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                          for m in spec["end_to_end"]}
        out["device"] = dev
    per_s = np.histogram(done[ok], bins=int(seconds), range=(t0, t0 + int(seconds)))[0]
    # how the window served, for reading (no bound holds them, PERF.md); in
    # the traced run its two holds at the slice's edges are inside it
    def grew(what):
        return after.get(batch[what], 0.0) - before.get(batch[what], 0.0)

    batches = grew("batches") if batch else 0.0
    out["window"] = {"gave_up": gave_up, "answered_in_window": in_window,
                     "qps": in_window / seconds,
                     "p95_ms": float(np.percentile(lat, 95)) if len(lat) else None,
                     "answers_per_second": per_s.tolist(), "cpu_s": cpu_s,
                     "batch_size": grew("queries") / batches if batches else None,
                     "enqueue_ms": 1e3 * grew("seconds") / batches if batches else None,
                     "load_s": load_s,
                     "recall": values["recall"], "gc_count": gc_clock.count,
                     "gc_s": gc_clock.total_s, "gc_longest_s": gc_clock.longest_s}
    out["checks"] = checks
    return out


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m vsbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", metavar="JSON", default=None,
                   help="tests only: run on the CPU with the sizes in this file")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    spec = resolve(args.workload, args.rehearse)
    chips = int(spec["cell"].get("chips", 1))
    import torch

    if args.rehearse:
        device = "cpu"
    elif not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vsbench: the cell needs {chips} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    else:
        device = "cuda"
    out = asyncio.run(measure(spec, args.seed, args.seconds, bool(args.trace), device))
    bad = forbidden_modules()
    if bad:
        print(f"vsbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    # a crash in any thread leaves every thread's stack on standard error
    faulthandler.enable(file=sys.stderr, all_threads=True)
    sys.exit(main())
