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
    with metrics.timed("vst_search_seconds", backend="ivf"):
        ...
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

# log-spaced latency buckets (seconds): 1ms .. ~16s, the serving range
BUCKETS = tuple(0.001 * 2**i for i in range(15))

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
        with _lock:
            h = _hists.get(self._k)
            if h is None:
                h = _hists[self._k] = [[0] * (len(BUCKETS) + 1), 0.0, 0]
            i = 0
            while i < len(BUCKETS) and seconds > BUCKETS[i]:
                i += 1
            h[0][i] += 1
            h[1] += seconds
            h[2] += 1


def counter(name: str, **labels) -> _Counter:
    return _Counter(_key(name, labels))


def histogram(name: str, **labels) -> _Histogram:
    return _Histogram(_key(name, labels))


@contextmanager
def timed(name: str, **labels):
    t0 = time.time()
    try:
        yield
    finally:
        histogram(name, **labels).observe(time.time() - t0)


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
