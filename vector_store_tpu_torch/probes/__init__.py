"""Measurement probes of the port on a CUDA card, run as modules:

    python -m vector_store_tpu_torch.probes.dma          B4, the copy-rate roofline
    python -m vector_store_tpu_torch.probes.fused_sweep  B1 over probes and score modes
    python -m vector_store_tpu_torch.probes.two_stage    the two-stage scan over probes x cand

Ports of scripts/probe_dma.py, probe_fused_sweep.py and probe_two_stage.py.
They time with CUDA events and refuse to run without a card.  The two IVF
probes build the bench corpus with `probes.data.make_dataset` (bench.py's
recipe and seed, numpy only) and cache the built index under the JAX
scripts' name, vst_ivf_{N}_int8_rpb{RPB}.npz, in the temporary directory
(TMPDIR, else /tmp) and the snapshot format both packages read.  Importing
a probe imports no jax.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

DIM = 768


def require_cuda():
    """torch, after checking that a CUDA card is visible (exit 2 if not)."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device visible: the probes measure the card", file=sys.stderr)
        raise SystemExit(2)
    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 route and oracle
    return torch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Best over 3 blocks of the mean ms of 8 calls fn(r), r = 0..7, by
    CUDA events on the current stream, after one warm-up call."""
    reps = 8
    fn(0)
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for r in range(reps):
            fn(r)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def snapshot_path(n: int, rpb: int) -> str:
    """The JAX scripts' cache name, in this process's temporary directory
    (TMPDIR, else /tmp)."""
    return os.path.join(tempfile.gettempdir(), f"vst_ivf_{n}_int8_rpb{rpb}.npz")


def load_or_build(n: int, rpb: int, cluster_min: int | None = None):
    """(IvfIndex, corpus, queries): the int8 cosine index of the bench
    corpus at rows per bucket `rpb`, restored from its snapshot when one
    exists and holds that index, else built with one add() and saved.  A
    snapshot that does not load, or holds another index, is left as it is
    and not overwritten."""
    from ..core.ivf import IvfIndex
    from ..types import IndexParams
    from .data import make_dataset

    x, queries = make_dataset(n, DIM, 2048)
    snap = snapshot_path(n, rpb)
    if os.path.exists(snap):
        t0 = time.time()
        try:
            idx = IvfIndex.load(snap, device="cuda")
        except (OSError, KeyError, ValueError) as e:
            idx, why = None, f"{type(e).__name__}: {e}"
        else:
            got = (idx.dims, idx.space, idx.dtype, idx.rows_per_bucket, idx.count)
            why = f"holds {got}" if got != (DIM, "cosine", "int8", rpb, n) else None
        if why is None:
            print(f"# restored in {time.time() - t0:.0f}s clusters={idx.n_clusters} "
                  f"bucket={idx.state.bucket}", flush=True)
            return idx, x, queries
        print(f"# snapshot {snap} not used ({why}); building without saving", flush=True)
        snap = None
    kw = {"cluster_min": cluster_min} if cluster_min else {}
    idx = IvfIndex(
        IndexParams(dimensions=DIM, space="cosine", dtype="int8"),
        initial_capacity=n,
        rows_per_bucket=rpb,
        device="cuda",
        **kw,
    )
    t0 = time.time()
    idx.add(x)
    print(f"# build: {n / (time.time() - t0):.0f} vec/s clusters={idx.n_clusters} "
          f"bucket={idx.state.bucket}", flush=True)
    if snap is not None:
        idx.save(snap)
    return idx, x, queries
