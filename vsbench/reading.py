"""What a per-layer metric's reader is given: the rows the set-up loaded and
the seconds the load took, the program's counters at the edges of the
window and of the profiled slice (and the name of the driver's counter of
query batches), and the slice's device operations.

A reader is a file vsbench/metrics/<metric name>.py with one function,
`read(r: Reading) -> float | None`.  It returns None where it finds
nothing to read, and the metric is then left out of the result.
"""

from __future__ import annotations

from . import trace


class Reading:
    def __init__(self, window: tuple[dict, dict], in_slice: tuple[dict, dict],
                 the_slice: "trace.Slice", on_device: bool,
                 load: tuple[int, float] = (0, 0.0), batches: str | None = None) -> None:
        # (rows, seconds) of the set-up's load through the system's entry
        self.load_rows, self.load_s = load
        # the driver's counter of the program's query batches, if it names one
        self.batches = batches
        self.window = window
        self.in_slice = in_slice
        self.on_device = on_device
        self.slice_s = the_slice.seconds
        self.ops = trace.device_ops(the_slice.events, the_slice.start_ns, the_slice.stop_ns)
        self.busy_s = trace.busy_ns(self.ops) / 1e9

    def delta(self, name: str, where: str = "window") -> float:
        """How much the program's counter `name` grew over the window (or
        over the slice, `where="slice"`)."""
        before, after = self.window if where == "window" else self.in_slice
        return after.get(name, 0.0) - before.get(name, 0.0)

    def per_slice_batch(self, value: float) -> float | None:
        """`value` over the query batches the program enqueued in the slice
        (the driver's batch counter), or None where it counted none."""
        batches = self.delta(self.batches, "slice") if self.batches else 0.0
        return value / batches if batches > 0 else None

    def device_seconds(self, *names: str) -> float | None:
        """Device seconds of the operations whose name holds one of `names`,
        or None where none ran in the slice."""
        hits = [e - s for n, s, e in self.ops if any(x in n for x in names)]
        return sum(hits) / 1e9 if hits else None
