"""The traced run's profiler slice and its reduction to device intervals.

The profiler covers one bounded slice in the middle of the window, with
device activity only (no CPU operators, stacks, shapes or memory), so the
number of events stays in the tens of thousands even on the graph's
launch-bound path.  It is started and stopped on the event loop's thread.

The device's operations (kernels, copies, sets) come from the profiler's
raw results as (name, start_ns, end_ns) in nanoseconds since the epoch,
which Python's time_ns reads too; the host's CUDA runtime calls come with
them and name what the host was doing in an idle gap.
"""

from __future__ import annotations

import re
import time

import torch

# the slice: at most SLICE_S seconds, at most SLICE_SHARE of the window,
# centred in it
SLICE_S = 2.0
SLICE_SHARE = 0.2


def slice_edges(seconds: float) -> tuple[float, float]:
    """(start, length) of the slice, in seconds from the window's start."""
    length = min(SLICE_S, SLICE_SHARE * seconds)
    return (seconds - length) / 2, length


class Slice:
    """One profiler slice.  `device` False (a rehearsal on the CPU) traces
    CPU operators instead, which give no device interval."""

    def __init__(self, device: bool) -> None:
        act = torch.profiler.ProfilerActivity
        self._device = device
        self._prof = torch.profiler.profile(activities=[act.CUDA if device else act.CPU])
        self.start_ns = self.stop_ns = 0
        self.events: list = []

    def start(self) -> None:
        self._prof.start()
        # the first launch after a start pays the tracer's setup (~0.2 s on
        # the H100); pay it here, before the slice's clock starts
        _tiny_op(self._device)
        self.start_ns = time.time_ns()

    def stop(self) -> None:
        self.stop_ns = time.time_ns()
        self._prof.stop()

    def collect(self) -> None:
        """Keep the slice's raw events as plain tuples and drop the rest."""
        cuda = torch.autograd.DeviceType.CUDA
        self.events = [
            (e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.device_type() == cuda)
            for e in self._prof.profiler.kineto_results.events()
        ]
        self._prof = None

    @property
    def seconds(self) -> float:
        return (self.stop_ns - self.start_ns) / 1e9


def _tiny_op(device: bool) -> None:
    x = torch.ones(16, device="cuda" if device else "cpu")
    (x + x).sum().item()


def warm_profiler(device: bool) -> None:
    """Start and stop a profiler once during set-up, so the first start in
    the window does not pay the tracer's initialisation."""
    s = Slice(device)
    s.start()
    s.stop()
    s.collect()


def device_ops(events, start_ns: int, stop_ns: int) -> list[tuple[str, int, int]]:
    """The device's operations, clipped to [start_ns, stop_ns]."""
    out = []
    for name, s, e, on_device in events:
        if on_device and e > start_ns and s < stop_ns:
            out.append((name, max(s, start_ns), min(e, stop_ns)))
    out.sort(key=lambda op: op[1])
    return out


def busy_ns(ops) -> int:
    """Length of the union of the operations' intervals (ops sorted by
    start)."""
    total, cur_s, cur_e = 0, None, None
    for _, s, e in ops:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def short_name(name: str) -> str:
    """An operation's name without its return type, template arguments and
    parameters."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name).split("(", 1)[0]
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def top_ops(ops, n: int = 10) -> list[list]:
    """[[name, seconds]] of the operations that took most device time."""
    by: dict[str, int] = {}
    for name, s, e in ops:
        key = short_name(name)
        by[key] = by.get(key, 0) + (e - s)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in top]


def idle_gaps(ops, events, start_ns: int, stop_ns: int, n: int = 10) -> list[list]:
    """[[what the host was doing, seconds]] of the longest gaps in which no
    device operation ran: the CUDA runtime call that covered most of the
    gap, or "host outside CUDA calls", and the operation that ended it."""
    gaps, last_end = [], start_ns
    for name, s, e in ops:
        if s > last_end:
            gaps.append((s - last_end, last_end, s, short_name(name)))
        if e > last_end:
            last_end = e
    if stop_ns > last_end:
        gaps.append((stop_ns - last_end, last_end, stop_ns, "slice end"))
    gaps.sort(key=lambda g: -g[0])
    host = [(nm, s, e) for nm, s, e, on_device in events if not on_device]
    out = []
    for length, gs, ge, after in gaps[:n]:
        best, cover = "host outside CUDA calls", 0
        for nm, s, e in host:
            c = min(e, ge) - max(s, gs)
            if c > cover:
                best, cover = f"host in {nm}", c
        out.append([f"{best}, then {after}", length / 1e9])
    return out
