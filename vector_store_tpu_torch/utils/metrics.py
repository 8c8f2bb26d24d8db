"""Process-global metrics registry with Prometheus text exposition.

The reference has NO metrics surface (SURVEY §5: "no metrics registry,
no health endpoint" — logs only); this closes that operability gap for
a service meant to run as a production sidecar.  Deliberately tiny:
counters and fixed-bucket latency histograms behind one lock, rendered
in the Prometheus text format at GET /metrics (api/routes.py) so any
standard scraper works — no client-library dependency.

Usage:
    from vector_store_tpu_torch.utils import metrics
    metrics.counter("vst_http_requests_total", route="/ann", status="200").inc()
    with metrics.span("vst_search_seconds", backend="ivf"):
        ...

A span times the host on the monotonic clock and observes the histogram of
its name.  While a torch.profiler runs it is also a `record_function` range
of that name, so it lies on the profiler's timeline beside the device's
operations and nests as the calls do (engine -> index -> kernel wrapper);
with no profiler running that costs one flag read.  `span(name, series=False)`
marks the trace only.
"""

from __future__ import annotations

import bisect
import threading
import time

from torch.autograd import profiler as _torch_profiler

# log-spaced latency buckets (seconds): ~1us .. ~16s; the bounds from 1 ms up
# are the serving range's, the finer ones below it hold a lock wait or an
# enqueue
BUCKETS = tuple(0.001 * 2**i for i in range(-10, 15))

_lock = threading.Lock()
_counters: dict[tuple[str, tuple], float] = {}
_hists: dict[tuple[str, tuple], list] = {}  # [counts per bucket + inf, sum, n]


def _key(name: str, labels: dict) -> tuple[str, tuple]:
    return name, tuple(sorted(labels.items()))


class _Counter:
    __slots__ = ("_k",)

    def __init__(self, k):
        self._k = k

    def inc(self, n: float = 1.0) -> None:
        with _lock:
            _counters[self._k] = _counters.get(self._k, 0.0) + n


class _Histogram:
    __slots__ = ("_k",)

    def __init__(self, k):
        self._k = k

    def observe(self, seconds: float) -> None:
        self.observe_many((seconds,))

    def observe_many(self, values) -> None:
        """One observation per value, under one lock."""
        with _lock:
            h = _hists.get(self._k)
            if h is None:
                h = _hists[self._k] = [[0] * (len(BUCKETS) + 1), 0.0, 0]
            counts = h[0]
            for seconds in values:
                counts[bisect.bisect_left(BUCKETS, seconds)] += 1
                h[1] += seconds
                h[2] += 1


def counter(name: str, **labels) -> _Counter:
    return _Counter(_key(name, labels))


def histogram(name: str, **labels) -> _Histogram:
    return _Histogram(_key(name, labels))


class span:
    """Context manager: the seconds of its body observed into the histogram
    `name` with `labels` (none with `series=False`), and a profiler range
    `name` while a torch.profiler runs.  `with span(...) as labels` hands
    back the labels, which the body may still change (a label known only
    at the end)."""

    __slots__ = ("_name", "_labels", "_series", "_range", "_t0")

    def __init__(self, name: str, series: bool = True, **labels) -> None:
        self._name = name
        self._series = series
        self._labels = labels
        self._range = None

    def __enter__(self) -> dict:
        if _torch_profiler._is_profiler_enabled:
            self._range = _torch_profiler.record_function(self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self._labels

    def __exit__(self, *exc) -> None:
        took = (time.perf_counter_ns() - self._t0) * 1e-9
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self._series:
            histogram(self._name, **self._labels).observe(took)


def _esc(v) -> str:
    # Prometheus exposition label-value escaping: \ " and newline.  Label
    # values can carry user-controlled index ids — unescaped quotes would
    # corrupt the whole scrape payload.
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(label_items: tuple, extra: str = "") -> str:
    parts = [f'{k}="{_esc(v)}"' for k, v in label_items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render() -> str:
    """Prometheus text exposition format (version 0.0.4)."""
    out: list[str] = []
    with _lock:
        for (name, labels), v in sorted(_counters.items()):
            out.append(f"{name}{_fmt_labels(labels)} {v:g}")
        for (name, labels), (counts, total, n) in sorted(_hists.items()):
            cum = 0
            for bound, c in zip(BUCKETS, counts):
                cum += c
                out.append(
                    f"{name}_bucket{_fmt_labels(labels, f'le="{bound:g}"')} {cum}"
                )
            out.append(
                f"{name}_bucket{_fmt_labels(labels, 'le="+Inf"')} {cum + counts[-1]}"
            )
            out.append(f"{name}_sum{_fmt_labels(labels)} {total:g}")
            out.append(f"{name}_count{_fmt_labels(labels)} {n}")
    return "\n".join(out) + "\n"


def reset() -> None:
    """Test isolation hook."""
    with _lock:
        _counters.clear()
        _hists.clear()
