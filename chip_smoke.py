#!/usr/bin/env python3
"""Bring-up check of vector_store_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the kernels from csrc/ with nvcc (one process per source, in
parallel), then:

  0. prints the card (nvidia-smi name and power limit), the torch and CUDA
     versions and the kernels' build time;
  1. holds each kernel against its plain PyTorch version at serving shapes
     (Q=256 queries, p=16 probes, bucket B=640, D=768; int8, bf16 and f32
     banks; cosine, dot and l2; B1 at k=10 and 32, B2 also over the packed
     int4 bank), with a tenth of the rows tombstoned and short live
     prefixes, and times both with CUDA events; holds B2 at D=4,096 and
     4,100 (past B1's limit: its tiles then take the row in chunks)
     against its plain version on a small bank; checks B1's work list on
     the card, that one B1 call (3 kernels) and one B2 call (2: B1's work
     list, then the tile scan with B2's epilogue) run with torch's
     synchronisation check set to raise (torch.profiler counts them),
     times B1 in every mode beside its bound, and B2 on the int8 bank, its
     packed int4 derivative, bf16 and f32 (cold L2, in turns), at D=768
     and at D=4,096 on banks of 0.7-5.4 GB;
 1b. grows a bucket to 4,096 rows by skewed ingest (65,536 rows, then
     10,000 near-copies of one): IvfIndex.search answers k 10 through B1
     alone, as B1's plain version would, and k 50 through B2 alone, whose
     pool is held against B2's plain version;
  2. serves an int8 IVF index over HTTP (in-process server on 127.0.0.1),
     bulk-loads N rows of the bench corpus recipe (default 1,000,000 x 768;
     VST_SMOKE_N lowers it for local runs) through the engine handle in
     8,192-row batches plus 256 rows through POST .../add;
  3. sends 512 limit-10 queries over HTTP with 64 in flight, checks
     recall@10 >= 0.90 against an exact f32 oracle on the card, sends 8
     limit-50 queries, checks that the HTTP path launched both kernels,
     times IvfIndex.search on 2,048 queries in one call, and B1 in every
     mode at the HTTP batch shape (64 queries, p 16) beside its bound;
  4. holds the graph kernel B3's two entry points against their plain
     versions on a 262,144 x 768 bank (f32, bf16, int8; cosine, dot, l2)
     at the search shape (Q=256, beam 4 x degree 32) and the insert shape
     (Q=1,024, beam 16 x degree 32): the ids-given entry with repeated ids,
     the expand entry (adjacency read and score in one launch) with dead
     beams, SENTINEL-padded adjacency rows and repeated nodes; ids equal,
     INF where the plain version has INF; times both (cold L2, in turns)
     beside their bounds;
  5. serves a kind-"ann" (graph) index over HTTP: the route's default
     dtype (bf16), cosine, capacity 131,072; bulk-loads 131,072 rows of the
     bench corpus recipe through the engine handle plus 256 through
     POST .../add, sends 512 limit-10 queries with 64 in flight and checks
     recall@10 >= 0.90 against SlotIndex.exact_search on the same bank,
     removes 1,000 keys and checks none comes back, compacts and checks
     count and recall after the slot remap; B3 must launch during both
     ingest and queries; on the served graph, the distinct share of each
     expand round's candidates for a search and for an insert block, and
     the device operations of one search (torch.profiler);
  6. builds the graph at the JAX package's recorded geometry (131,072 x 768
     f32, one add() in 1,024-row blocks), checks recall@10 >= 0.95 at ef 64
     (the TPU record is 0.983), times ingest and SlotIndex.search on 2,048
     queries; the distinct shares as in phase 5, and the middle expand
     round of a search and of an insert block captured and held and timed
     as in phase 4 (the graph's bank and bf16 and int8 copies of it:
     real overlap between candidates); rebuilds the centroid router (4,096
     centroids) and reports recall through routed entries, then counts the
     device operations of one more insert block;
  7. holds B1's qi8, bf16 and stub score modes against their plain versions
     at phase 1's shapes (int8, the stub also on bf16 and f32 banks; cosine
     and dot; k 10 and 32) and times them, then times B1 in every mode at
     Q=256, p=16 and at Q=1,024, p=2 on the bench-geometry index of phase 3
     (rows per bucket 340; an int8 bank of over 1 GiB), B2 at both shapes
     on it and on its packed int4 coarse bank (cold L2, in turns), and
     takes recall@10 of each mode on it (probes 2, 2,048 queries);
  8. on that index: derive_coarse's time, the two-stage scan's recall@10
     and batch QPS at probes 2 and 4 beside the single-stage scan's (B2
     packed must launch), then a save -> load round trip in a temporary
     directory whose loaded index must return the same ids;
  9. holds the copy-rate probe B4 against its plain version on a small
     bank, measures its GB/s over a >= 1 GiB bank at blocks of 128, 384,
     768 and 1,536 rows, score on and off, and prints B1's and B2's GB/s
     on the bench-geometry index (phase 7), of the bytes each must move
     once (every distinct probed bucket once), as a share of B4's copy rate
     at 128 rows; a share over 1 fails the phase;
 10. text search: (a) over HTTP on the card, a text index takes 2,000
     documents (zipf over 20,000 words, 24 words each) and answers plain,
     +/- operator, phrase and prefix queries, each held against a numpy
     BM25 oracle written here, again after 100 documents are replaced and
     100 removed; (b) a BM25Index of 100,000 such documents on the card:
     the top-10 of 32 queries against the oracle (keys in order wherever
     scores are distinct, by score elsewhere), the same answers from a
     device="cpu" index on a 10,000-document prefix; prints docs/s of
     ingest, ms of the device pass for 32 queries, end-to-end search() QPS
     over turns and the phase's peak device memory, which must stay under
     8 GB;
 11. (run after phase 6, on its graph) saves the 131,072 x 768 graph with
     core/persist.py, loads it and checks that 256 queries return the same
     ids through B3; prints seconds and the file's size;
 12. the ingest pipeline: MemDb.preload of 250,000 x 768 rows ->
     MonitorIndexes -> monitor_items -> an int8 IVF index made with
     reserve_rows, three times over (vec/s, median and range); recall@10
     >= 0.90 of 256 queries through the index handle (B1 must launch);
     then 2,000 overwrites and 1,000 tombstones through the source's live
     events, and the count and answers that follow from them; B1 is held
     against its plain version on that index's bank (256 queries, its
     probes, k 10) before the searches and after the burst, and its launch
     count is taken over the phase's searches, from 0 after the fill.

 13. the sharded backends as four logical shards on the one card (a mesh
     that names cuda:0 four times): kind "ivf" with n_devices=4 over HTTP
     on the rows of phase 2 (recall@10 >= 0.90 and >= phase 3's minus 0.05;
     B1 launched once a chunk on every shard, and held against its plain
     version on one shard's bank; keys back from gids; limit 50 through
     B2), the two-stage scan on those banks (recall >= 0.85 and >= the
     single-stage's minus 0.10; B2 packed on every shard, and held against
     its plain version on one shard's packed bank), a snapshot saved,
     loaded onto the same mesh and searched (the same ids; a mesh of two is
     refused); ingest vec/s and batch QPS of a 4-shard index beside a
     1-shard index of the same rows, in turns, and the merge's share of a
     chunk's device time; one first clustering of 1,000,000 rows through the
     host with the threshold forced, its bank equal tensor for tensor to
     the device permute of the same plan; kind "ann" with n_devices=4 over
     HTTP (131,072 + 256 rows, bf16: recall@10 >= 0.90 against the exact
     f32 oracle, B3 on every shard and held against its plain version on a
     round captured from one shard's graph, 1,000 removes, a compaction
     whose gid remap the keymap follows); a ShardedBM25Index of phase 10's 100,000
     documents against the single index and the oracle.

Any failed phase raises and the exit code is non-zero.  The last line is
{"ok": true, "device": {...}}, the line before it the kernels' record, each
with its bound: the bytes the function must move (each input read once,
each output written once) over 3.35 TB/s or its operations over the peak
of their type, whichever is larger (HBM_BYTES_S, PEAK_OPS_S).
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

KS, IX = "smoke", "corpus"
DIM = 768
SEED = 42
TOL = 1e-5  # absolute: f32 sums of unit-norm rows, taken in another order
ADD_BATCH = 8192
EXTRA_ROWS = 256
N_HTTP, N_BATCH, IN_FLIGHT = 512, 2048, 64
MIN_RECALL = 0.90
# the graph: the recorded geometry's corpus, and the recall it must reach
GIX = "graph"
N_GRAPH = 131_072
N_REMOVE = 1000
MIN_RECALL_GEOMETRY = 0.95
TPU_RECALL_GEOMETRY = 0.983  # BENCH_r05, graph ef=64 @ N=131072 (a TPU record)
# bound_ms: one H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
# the units each kernel multiplies on, as (peak, products per operation):
# B1's f32 and bf16 modes (the query rounded to bf16 first) and B2's int8
# and packed int4 banks run on the int8 tensor cores with the query as four
# int8 digits, four products each; qi8 with one; the stub multiplies
# nothing; bf16 and f32 banks (B2) and B3 and B4 on CUDA cores in f32
F32_CORES = ("f32", 1)
MODE_UNITS = {"f32": ("int8", 4), "bf16": ("int8", 4), "qi8": ("int8", 1), "stub": None}
B2_UNITS = {"int8": ("int8", 4), "int4-packed": ("int8", 4), "bfloat16": F32_CORES,
            "float32": F32_CORES}


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# data: the bench corpus recipe (clustered gaussian, seeded PCG64)


def make_corpus(n: int, d: int, seed: int = SEED) -> np.ndarray:
    """n rows around n/50 gaussian centres, sigma 0.35: the bench corpus
    (vector_store_tpu_torch/probes/data.py)."""
    from vector_store_tpu_torch.probes import data

    return data.make_corpus(n, d, seed)


def make_queries(x: np.ndarray, q: int, seed: int = SEED) -> np.ndarray:
    """In-distribution queries: corpus rows plus sigma-0.25 noise."""
    from vector_store_tpu_torch.probes import data

    return data.make_queries(x, q, seed)


def make_extra(x: np.ndarray, m: int, seed: int = SEED) -> np.ndarray:
    rng = np.random.default_rng([seed, 2])
    qi = rng.choice(len(x), m, replace=False)
    return x[qi] + 0.35 * rng.standard_normal((m, x.shape[1]), dtype=np.float32)


# --------------------------------------------------------------------------
# phase 1: kernels against their plain versions


def _bank(torch, dtype, K, B, D, gen, device):
    from vector_store_tpu_torch.core.distance import normalize
    from vector_store_tpu_torch.core.quantize import quantize_rows

    rows = normalize(torch.randn((K * B, D), generator=gen, device=device))
    if dtype == "int8":
        codes, scales = quantize_rows(rows)
        return codes.reshape(K, B, D), scales.reshape(K, B)
    ones = torch.ones((K, B), device=device)
    if dtype == "bfloat16":
        return rows.to(torch.bfloat16).reshape(K, B, D), ones
    return rows.reshape(K, B, D), ones


def _compare_topk(torch, d_k, r_k, d_ref, r_ref, k):
    """(max |d err| over finite entries, share of ids equal, positions
    compared).  Ids are compared where the reference distance differs from
    both neighbours by more than TOL; the reference carries k+1 entries so
    position k-1 has a right neighbour."""
    d_ref_k = d_ref[:, :k]
    if not torch.equal(torch.isinf(d_k), torch.isinf(d_ref_k)):
        raise AssertionError("INF pattern differs between kernel and plain")
    fin = torch.isfinite(d_ref_k)
    err = float((d_k - d_ref_k)[fin].abs().max()) if fin.any() else 0.0
    gap = (d_ref[:, 1:] - d_ref[:, :-1]).nan_to_num(nan=float("inf"))  # inf - inf
    sep = gap[:, :k] > TOL
    sep[:, 1:] &= gap[:, : k - 1] > TOL
    n_sep = int(sep.sum())
    if n_sep == 0:
        raise AssertionError("no separated positions to compare ids on")
    agree = int((r_k[sep] == r_ref[:, :k][sep]).sum()) / n_sep
    return err, agree, n_sep


_FLUSH = []  # a device buffer larger than the 50 MB L2, written before cold launches
# device cycles (~0.1 ms) the stream waits before each timed call, so that
# the host has enqueued the call before its start event is reached: the
# events then time the device, not the host's enqueue
_WAIT_CYCLES = 200_000


def _time_ms(torch, fn, reps, cold=False):
    """ms per call of fn by CUDA events, after one warm-up call.  Warm:
    `reps` calls back to back between two events (a call may find the
    previous one's rows in L2).  Cold: before each call a 128 MB buffer is
    written, which evicts L2, and each call is timed by its own events.
    Either way the stream first waits on the device (torch.cuda._sleep)
    while the host enqueues, so a wrapper's host time is not counted."""
    fn()
    torch.cuda.synchronize()
    if not cold:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_WAIT_CYCLES * reps)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    if not _FLUSH:
        _FLUSH.append(torch.empty(32 << 20, dtype=torch.float32, device="cuda"))
    events = []
    for _ in range(reps):
        _FLUSH[0].fill_(1.0)
        torch.cuda._sleep(_WAIT_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def _turns(torch, fns: dict, reps, rounds=2, cold=True) -> dict:
    """Each named call timed in turns: the names in order, then reversed
    (a, b, b, a for two), `rounds` times, so that a drift of the card's
    clocks falls on all of them.  `reps` is an int or {name: int}.
    Returns {name: (median ms, lowest, highest)} over the turns."""
    times = {name: [] for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            n = reps[name] if isinstance(reps, dict) else reps
            times[name].append(_time_ms(torch, fns[name], n, cold))
    return {name: (float(np.median(t)), min(t), max(t)) for name, t in times.items()}


def _fmt(t) -> str:
    """'median ms [lowest-highest]' of a _turns entry."""
    return f"{t[0]:.4f} ms [{t[1]:.4f}-{t[2]:.4f}]"


def _count_kernels(torch, fn, names=None) -> int:
    """Device operations (kernels, copies, memsets) one call of fn runs,
    counted by torch.profiler; their names are appended to `names`."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if names is not None:
        names += ops
    return len(ops)


def _bound(nbytes: float, ops: float, units: tuple[str, int] | None) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): the bytes the function must move
    over the HBM rate, or its operations over the peak of the units that
    run them, (peak, products per operation) as in MODE_UNITS."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops * units[1] / PEAK_OPS_S[units[0]] * 1e3 if units else 0.0
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b1_work(torch, rid, nsb, cids, D, elem, k, pool_out=False):
    """(bytes, operations) of one B1 call (B2's with `pool_out`) on these
    inputs: each distinct probed bucket's live rows read once (row bytes and
    scale) and the rowids of its live prefix, the f32 queries and the cids,
    the outputs written once ([Q, k] f32 + int32, or B2's [Q, p*B] f32
    pool); 2*D operations per (live row, probing query)."""
    from vector_store_tpu_torch.core.topk import SENTINEL

    Q, p = cids.shape
    B = rid.shape[1]
    c = cids.long()
    live = (rid != SENTINEL).sum(dim=1)
    prefix = torch.clamp(nsb.long() * 128, max=B)
    u = torch.unique(c)
    out = Q * p * B * 4 if pool_out else Q * k * 8
    rows, slots = int(live[u].sum()), int(prefix[u].sum())
    nbytes = rows * (D * elem + 4) + slots * 4 + Q * D * 4 + Q * p * 4 + out
    return nbytes, 2 * D * int(live[c].sum())


def _kernel_us(torch, call, reps=5) -> dict:
    """Device microseconds per call of each kernel `call` launches
    (torch.profiler, mean of `reps` calls)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = (re.findall(r"\w+_kernel", e.name) or [e.name[:40]])[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / reps
    return out


def b1_shape(torch, label, vec, scl, rid, q, cids, nsb, reps=20):
    """B1 timed in every mode (cosine, k 10) at one shape, twice, each
    beside its bound; then its f32 call split by kernel (work list, scan,
    merge) and the host's time to enqueue one call; returns {mode: numbers,
    "kernels_us": {...}, "host_ms": t}."""
    from vector_store_tpu_torch.core import ivf_cuda as ic

    out = {}
    D = vec.shape[2]
    nbytes, ops = b1_work(torch, rid, nsb, cids, D, vec.element_size(), 10)
    for mode in ("f32", "qi8", "bf16", "stub"):
        def run():
            return ic.search_fused(vec, scl, rid, q, cids, "cosine", 10, nsb, mode)

        t1, t2 = _time_ms(torch, run, reps), _time_ms(torch, run, reps)
        bound, by = _bound(nbytes, ops, MODE_UNITS[mode])
        ms = (t1 + t2) / 2
        out[mode] = {"ms": ms, "bound_ms": bound, "bound_by": by}
        log(f"  B1 {label} {mode:4s}: {t1:.4f}/{t2:.4f} ms; bound {bound:.4f} ms ({by}), "
            f"share {bound / ms:.3f}")
    def f32():
        return ic.search_fused(vec, scl, rid, q, cids, "cosine", 10, nsb)

    out["kernels_us"] = _kernel_us(torch, f32, reps=10)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        f32()
    out["host_ms"] = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    log(f"  B1 {label} f32 by kernel, us per call: "
        + ", ".join(f"{k} {v:.2f}" for k, v in out["kernels_us"].items())
        + f"; host enqueue {out['host_ms']:.4f} ms per call")
    return out


def _turns_ms(torch, kern, plain, k_reps, p_reps):
    """(kernel ms, plain ms), warm, in the turns plain, kernel, kernel,
    plain, so that a drift of the card's clocks falls on both."""
    t = _turns(torch, {"plain": plain, "kernel": kern}, {"plain": p_reps, "kernel": k_reps},
               rounds=1, cold=False)
    return t["kernel"][0], t["plain"][0]


def _scan_case(torch, gen, Q, p, B, D, K, device):
    """(masked rowids, live-prefix sub-blocks, queries, probed clusters,
    live rows read) of a synthetic K-bucket bank: a tenth of the rows
    tombstoned, every 8th bucket with a short live prefix."""
    from vector_store_tpu_torch.core import ivf_cuda as ic
    from vector_store_tpu_torch.core.distance import normalize
    from vector_store_tpu_torch.core.topk import SENTINEL

    rowid = torch.arange(K * B, dtype=torch.int32, device=device).reshape(K, B)
    dead = torch.rand((K, B), generator=gen, device=device) < 0.1
    # every 8th bucket keeps only a short live prefix
    prefix = torch.randint(0, B, (K,), generator=gen, device=device)
    short = (torch.arange(K, device=device) % 8 == 0)[:, None] & (
        torch.arange(B, device=device)[None, :] >= prefix[:, None]
    )
    rid = torch.where(dead | short, SENTINEL, rowid)
    nsb = ic.live_prefix_blocks(rid != SENTINEL)
    q = normalize(torch.randn((Q, D), generator=gen, device=device))
    cids = torch.argsort(torch.rand((Q, K), generator=gen, device=device), dim=1)[:, :p]
    cids = cids.to(torch.int32).contiguous()
    # rows the kernels read: the live ones (tombstones and slots past the
    # live prefix are skipped without touching the bank)
    rows_read = (rid != SENTINEL).sum(dim=1)[cids.long()].sum().item()
    return rid, nsb, q, cids, rows_read


def b1_host_side(torch, cids, call) -> int:
    """B1's work list and launch discipline on the card: the work-list
    kernel's tiles hold every (query, rank) pair once, at most TILE pairs of
    one bucket each, no more tiles than pairs; `call` (one B1 call) runs
    with torch's synchronisation check set to raise and launches at most 4
    kernels (counted by torch.profiler).  Returns that count."""
    from vector_store_tpu_torch.core import ivf_cuda as ic

    order, start, n, n_tiles = ic.worklist(cids)
    order, start, n = order.cpu(), start.cpu(), n.cpu()
    nt = int(n_tiles.cpu()[0])
    flat = cids.reshape(-1).cpu()
    seen = torch.zeros(flat.numel(), dtype=torch.int64)
    for t in range(nt):
        pairs = order[int(start[t]) : int(start[t]) + int(n[t])].long()
        if not 1 <= len(pairs) <= ic.TILE or len(torch.unique(flat[pairs])) != 1:
            raise AssertionError(f"B1 work list: tile {t} holds {flat[pairs].tolist()}")
        seen[pairs] += 1
    want = int(((torch.bincount(flat.long()) + ic.TILE - 1) // ic.TILE).sum())
    if not (seen == 1).all() or nt != want:
        raise AssertionError(f"B1 work list: {nt} tiles (want {want}), pairs seen {seen.unique()}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = sorted({m for k in kernels for m in re.findall(r"\w+_kernel", k)})
    log(f"  B1 work list: {nt} tiles of <= {ic.TILE} pairs for {flat.numel()} pairs; one call "
        f"ran without a host synchronisation and launched {len(kernels)} kernels: {names}")
    if len(kernels) != ic.B1_KERNELS_PER_CALL or len(kernels) > 4:
        raise AssertionError(f"one B1 call launched {len(kernels)} kernels: {kernels}")
    return len(kernels)


def phase_kernels(torch, device="cuda", Q=256, p=16, B=640, D=DIM, K=512):
    from vector_store_tpu_torch.core import ivf_cuda as ic
    from vector_store_tpu_torch.core.quantize import pack_int4_from_int8
    from vector_store_tpu_torch.core.topk import topk_ascending_stable

    gen = torch.Generator(device=device).manual_seed(SEED)
    rid, nsb, q, cids, rows_read = _scan_case(torch, gen, Q, p, B, D, K, device)
    report = {"search_fused": {"err": 0.0, "agree": 1.0}, "pool_scan": {"err": 0.0, "agree": 1.0}}
    timing = {}
    banks = {dt: _bank(torch, dt, K, B, D, gen, device) for dt in ("int8", "bfloat16", "float32")}
    for dt, (vec, scl) in banks.items():
        for space in ("cosine", "dot", "l2"):
            for k in (10, 32):
                d_k, r_k = ic.search_fused(vec, scl, rid, q, cids, space, k, nsb)
                d_p, r_p = ic.search_fused_plain(vec, scl, rid, q, cids, space, k + 1, nsb)
                torch.cuda.synchronize()
                err, agree, n_sep = _compare_topk(torch, d_k, r_k, d_p, r_p, k)
                log(f"  B1 {dt:8s} {space:6s} k={k:2d}: max|d err| {err:.3e}  "
                    f"ids agree {agree:.4f} on {n_sep} separated")
                rep = report["search_fused"]
                rep["err"], rep["agree"] = max(rep["err"], err), min(rep["agree"], agree)
            variants = [(vec, False)]
            if dt == "int8":
                variants.append((pack_int4_from_int8(vec), True))
            for v, packed in variants:
                pool_k = ic.pool_scan_fused(v, scl, rid, q, cids, space, packed, nsb)
                pool_p = ic.pool_scan_plain(v, scl, rid, q, cids, space, packed, nsb)
                torch.cuda.synchronize()
                if not torch.equal(torch.isinf(pool_k), torch.isinf(pool_p)):
                    raise AssertionError("B2 INF pattern differs from plain")
                fin = torch.isfinite(pool_p)
                err = float((pool_k - pool_p)[fin].abs().max())
                d_p, pos_p = topk_ascending_stable(pool_p, 51)
                d_k, pos_k = topk_ascending_stable(pool_k, 50)
                err2, agree, n_sep = _compare_topk(torch, d_k, pos_k, d_p, pos_p, 50)
                name = f"{dt}{'-packed' if packed else ''}"
                log(f"  B2 {name:13s} {space:6s}: max|d err| {err:.3e}  "
                    f"top-50 ids agree {agree:.4f} on {n_sep} separated")
                rep = report["pool_scan"]
                rep["err"], rep["agree"] = max(rep["err"], err, err2), min(rep["agree"], agree)
    for name, rep in report.items():
        if rep["err"] > TOL or rep["agree"] < 1.0:
            raise AssertionError(f"{name}: kernel disagrees with plain: {rep}")

    report["pool_scan"]["err"] = max(report["pool_scan"]["err"], b2_wide(torch, device))

    # serving configuration: int8 bank, cosine, k=10; turns plain/kernel/kernel/plain
    vec, scl = banks["int8"]
    if device == "cuda":
        report["b1_kernels_per_call"] = b1_host_side(
            torch, cids, lambda: ic.search_fused(vec, scl, rid, q, cids, "cosine", 10, nsb))
        report["b2_kernels_per_call"] = launch_discipline(
            torch, "B2", lambda: ic.pool_scan_fused(vec, scl, rid, q, cids, "cosine", False, nsb),
            ic.B2_KERNELS_PER_CALL)
        report["b1_shape"] = b1_shape(torch, "phase 1", vec, scl, rid, q, cids, nsb)
    runs = {
        "search_fused": (
            lambda: ic.search_fused(vec, scl, rid, q, cids, "cosine", 10, nsb),
            lambda: ic.search_fused_plain(vec, scl, rid, q, cids, "cosine", 10, nsb),
        ),
    }
    for name, (kern, plain) in runs.items():
        ms, plain_ms = _turns_ms(torch, kern, plain, 50, 3)
        nbytes, ops = b1_work(torch, rid, nsb, cids, D, 1, 10)
        gbs = nbytes / (ms * 1e-3) / 1e9
        bound, by = _bound(nbytes, ops, MODE_UNITS["f32"])
        timing[name] = (ms, plain_ms, gbs, bound, by)
        log(f"  {name}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"({plain_ms / ms:.1f}x; {rows_read} live int8 rows probed, {gbs:.1f} GB/s of the "
            f"bytes it must move once; Q={Q} p={p} B={B} D={D}); bound {bound:.4f} ms ({by}), "
            f"share {bound / ms:.3f}")
    timing["pool_scan"] = b2_timing(torch, "phase 1", banks, rid, nsb, q, cids)
    del banks
    torch.cuda.empty_cache()
    if device == "cuda":
        timing["pool_scan_wide"] = b2_wide_timing(torch, Q, p, B, 4096, K)
    return report, timing


def launch_discipline(torch, label, call, want: int) -> int:
    """One call runs with torch's synchronisation check set to raise and
    launches `want` device operations (torch.profiler); returns the count."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = _count_kernels(torch, call)
    log(f"  {label}: one call ran without a host synchronisation and launched {n} kernels")
    if n != want:
        raise AssertionError(f"one {label} call launched {n} kernels, want {want}")
    return n


def b2_timing(torch, label, banks, rid, nsb, q, cids) -> dict:
    """B2 at one shape, cosine, cold L2, in turns: on each bank given and,
    for int8, its packed int4 derivative; each beside its plain version and
    its bound.  Returns {bank: (ms, plain_ms, GB/s, bound_ms, bound_by)},
    GB/s of the bytes the call must move once (b1_work: each distinct
    probed bucket once, the pool written once)."""
    from vector_store_tpu_torch.core import ivf_cuda as ic
    from vector_store_tpu_torch.core.quantize import pack_int4_from_int8

    out = {}
    Q, p = cids.shape
    for dt, (vec, scl) in banks.items():
        variants = [(dt, vec, False)]
        if dt == "int8":
            variants.append(("int4-packed", pack_int4_from_int8(vec), True))
        for name, v, packed in variants:
            D = q.shape[1]
            elem = 0.5 if packed else v.element_size()
            t = _turns(torch, {"kernel": lambda: ic.pool_scan_fused(
                v, scl, rid, q, cids, "cosine", packed, nsb)}, 20)
            plain = _turns(torch, {"plain": lambda: ic.pool_scan_plain(
                v, scl, rid, q, cids, "cosine", packed, nsb)}, 2, rounds=1)["plain"]
            nbytes, ops = b1_work(torch, rid, nsb, cids, D, elem, 10, pool_out=True)
            bound, by = _bound(nbytes, ops, B2_UNITS[name])
            ms = t["kernel"][0]
            gbs = nbytes / (ms * 1e-3) / 1e9
            out[name] = (ms, plain[0], gbs, bound, by)
            log(f"  B2 {label} {name:11s} cosine, cold L2: kernel {_fmt(t['kernel'])}, "
                f"plain {plain[0]:.4f} ms; bound {bound:.4f} ms ({by}), share "
                f"{bound / ms:.3f}; {gbs:.1f} GB/s of bytes moved once; Q={Q} p={p}")
    return out


def b2_wide(torch, device, Q=64, p=4, B=256, K=32) -> float:
    """B2 past FUSED_MAX_DIMS (its tiles then take the row in chunks, each
    adding its share of the distances to the pool) against its plain
    version on a small bank: int8, packed int4, bf16 and f32; cosine, dot,
    l2; at D=4,096 and at D=4,100 (rows not a multiple of 16 bytes: the
    one-row-a-warp path); INF exactly where the plain version has INF.
    Returns the max |d err|."""
    from vector_store_tpu_torch.core import ivf_cuda as ic
    from vector_store_tpu_torch.core.quantize import pack_int4_from_int8

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    worst = 0.0
    for D in (4096, 4100):
        rid, nsb, q, cids, _ = _scan_case(torch, gen, Q, p, B, D, K, device)
        for dt in ("int8", "bfloat16", "float32"):
            vec, scl = _bank(torch, dt, K, B, D, gen, device)
            variants = [(vec, False)] + ([(pack_int4_from_int8(vec), True)] if dt == "int8" else [])
            for v, packed in variants:
                for space in ("cosine", "dot", "l2"):
                    got = ic.pool_scan_fused(v, scl, rid, q, cids, space, packed, nsb)
                    want = ic.pool_scan_plain(v, scl, rid, q, cids, space, packed, nsb)
                    _sync(torch, device)
                    if not torch.equal(torch.isinf(got), torch.isinf(want)):
                        raise AssertionError(f"B2 D={D} {dt} packed={packed} {space}: INF pattern")
                    fin = torch.isfinite(want)
                    worst = max(worst, float((got - want)[fin].abs().max()))
    log(f"  B2 at D=4,096 and 4,100 (Q={Q} p={p} B={B}; int8, int4 packed, bf16, f32 x cosine, "
        f"dot, l2) vs plain: max|d err| {worst:.3e}, INF where the plain version has INF")
    if worst > TOL:
        raise AssertionError(f"B2 past FUSED_MAX_DIMS disagrees with its plain version: {worst}")
    return worst


def b2_wide_timing(torch, Q=256, p=16, B=640, D=4096, K=512) -> dict:
    """B2 at D=4,096 on phase 1's serving shape, each bank (0.7-5.4 GB, far
    past the 50 MB L2) made and freed in turn: held against its plain
    version (cosine), then timed as b2_timing does.  Returns b2_timing's
    {bank: (ms, plain_ms, GB/s, bound_ms, bound_by)}."""
    from vector_store_tpu_torch.core import ivf_cuda as ic

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rid, nsb, q, cids, _ = _scan_case(torch, gen, Q, p, B, D, K, "cuda")
    out = {}
    for dt in ("int8", "bfloat16", "float32"):
        banks = {dt: _bank(torch, dt, K, B, D, gen, "cuda")}
        vec, scl = banks[dt]
        got = ic.pool_scan_fused(vec, scl, rid, q, cids, "cosine", False, nsb)
        want = ic.pool_scan_plain(vec, scl, rid, q, cids, "cosine", False, nsb)
        fin = torch.isfinite(want)
        err = float((got - want)[fin].abs().max())
        if not torch.equal(torch.isinf(got), torch.isinf(want)) or err > TOL:
            raise AssertionError(f"B2 D={D} {dt} at Q={Q} p={p}: err {err}")
        del got, want, fin, vec, scl
        out.update(b2_timing(torch, f"D={D}", banks, rid, nsb, q, cids))
        del banks
        torch.cuda.empty_cache()
    return out


def big_bucket(torch, device="cuda", n=65_536, m=10_000):
    """A bucket grown to 4,096 rows by skewed ingest: n corpus rows (one
    recluster), then m near-copies of one row, which fill its first-choice
    clusters until the bucket doubles.  B1 keeps no [p*B] pool, so at k 10
    IvfIndex.search answers through B1 (which the old design could not take:
    its pool needed (768 + 16 x 4,096) x 4 bytes of shared memory), held
    against B1's plain version; at k 50 through B2, held against its plain
    version."""
    from vector_store_tpu_torch import IndexParams
    from vector_store_tpu_torch.core import ivf_cuda as ic
    from vector_store_tpu_torch.core.ivf import IvfIndex, scan_path
    from vector_store_tpu_torch.core.topk import topk_ascending_stable

    corpus = make_corpus(n, DIM)
    rng = np.random.default_rng([SEED, 3])
    skew = corpus[0] + 0.01 * rng.standard_normal((m, DIM), dtype=np.float32)
    idx = IvfIndex(IndexParams(dimensions=DIM, space="cosine", dtype="int8"), device=device)
    idx.add(corpus)
    idx.add(skew)
    B = idx.state.bucket
    paths = (scan_path(10, DIM), scan_path(50, DIM))
    if B < 4096 or paths != ("fused", "pool"):
        raise AssertionError(f"skewed ingest left bucket {B} (paths {paths}); want >= 4096")
    queries = np.concatenate([corpus[:256], skew[:256]])
    launches = {}
    for k in (10, 50):
        for key in ic.LAUNCHES:
            ic.LAUNCHES[key] = 0
        d, ids = idx.search(queries, k)
        launches[k] = dict(ic.LAUNCHES)
        if k == 10:
            d10, ids10 = d, ids
    st = idx.state
    qf, cids, _ = ic.route(st, torch.as_tensor(queries, device=device), "cosine", idx.probes)
    rid_masked, nsb = ic.scan_masks(st)
    # k 10: B1 against its plain version, same route
    d_ref, r_ref = ic.search_fused_plain(st.vectors, st.scales, rid_masked, qf, cids, "cosine", 11, nsb)
    _sync(torch, device)
    err, agree, n_sep = _compare_topk(
        torch, torch.as_tensor(d10, device=device), torch.as_tensor(ids10, device=device),
        d_ref, r_ref.long(), 10,
    )
    # k 50: B2's pool against its plain version, and the answer against the plain pool's top 50
    pool_k = ic.pool_scan_fused(st.vectors, st.scales, rid_masked, qf, cids, "cosine", False, nsb)
    pool_p = ic.pool_scan_plain(st.vectors, st.scales, rid_masked, qf, cids, "cosine", False, nsb)
    _sync(torch, device)
    if not torch.equal(torch.isinf(pool_k), torch.isinf(pool_p)):
        raise AssertionError("big bucket: B2 INF pattern differs from plain")
    fin = torch.isfinite(pool_p)
    err2 = float((pool_k - pool_p)[fin].abs().max())
    pd, pos = topk_ascending_stable(pool_p, 51)
    pr = torch.gather(rid_masked[cids.long()].reshape(pool_p.shape[0], -1), 1, pos)
    err3, agree2, n_sep2 = _compare_topk(
        torch, torch.as_tensor(d, device=device), torch.as_tensor(ids, device=device),
        pd, pr.long(), 50,
    )
    log(f"  bucket {B} x {idx.n_clusters} clusters after {m} skewed rows, {len(queries)} queries at "
        f"{idx.probes} probes: k 10 took {paths[0]!r}, launches {launches[10]}; vs B1's plain "
        f"version max|d err| {err:.3e}, ids agree {agree:.4f} on {n_sep} separated; k 50 took "
        f"{paths[1]!r}, launches {launches[50]}; B2 vs plain max|d err| {max(err2, err3):.3e}, "
        f"top-50 ids agree {agree2:.4f} on {n_sep2} separated")
    if launches[10]["search_fused"] == 0 or launches[10]["pool_scan"] != 0:
        raise AssertionError(f"k 10 on the big bucket did not go through B1 alone: {launches[10]}")
    if launches[50]["pool_scan"] == 0 or launches[50]["search_fused"] != 0:
        raise AssertionError(f"k 50 on the big bucket did not go through B2 alone: {launches[50]}")
    # recall@10 against the exact f32 oracle, the corpus queries and the
    # near-copies apart: an int8 bank cannot rank rows that differ by less
    # than its quantization step (tests/test_torch_ivf.py::
    # test_skewed_ingest_recalls_like_jax shows the JAX package agrees)
    truth = _oracle(torch, corpus, skew, queries, 10, device)
    rec_corpus = _recall(ids10[:256].tolist(), truth[:256])
    rec_skew = _recall(ids10[256:].tolist(), truth[256:])
    log(f"  recall@10 vs the exact f32 oracle: corpus queries {rec_corpus:.4f}, queries among the "
        f"{m} near-copies {rec_skew:.4f}, all {(rec_corpus + rec_skew) / 2:.4f}")
    # corpus rows find themselves (row 0 excepted: 10,000 near-copies surround it)
    self_found = (ids10[1:256, 0] == np.arange(1, 256)).all()
    if max(err, err2, err3) > TOL or min(agree, agree2) < 1.0 or not self_found:
        raise AssertionError(
            f"big-bucket search disagrees with the plain versions: {err} {err2} {agree} {agree2}")
    del idx
    torch.cuda.empty_cache()
    return {"bucket": B, "err": max(err, err2, err3), "launches": launches}


# --------------------------------------------------------------------------
# phases 2 and 3: the service


def _oracle(torch, corpus, extra, queries, k, device):
    """Exact cosine top-k ids over corpus ++ extra, f32 on the device."""
    from vector_store_tpu_torch.core.distance import normalize
    from vector_store_tpu_torch.core.topk import topk_ascending

    q = normalize(torch.as_tensor(queries, device=device))
    best_d = torch.full((len(q), k), float("inf"), device=device)
    best_i = torch.zeros((len(q), k), dtype=torch.long, device=device)
    step = 1 << 17
    for base, rows in ((0, corpus), (len(corpus), extra)):
        for off in range(0, len(rows), step):
            blk = normalize(torch.as_tensor(rows[off : off + step], device=device))
            d, i = topk_ascending(1.0 - q @ blk.T, min(k, len(blk)))
            best_d, pos = topk_ascending(torch.cat([best_d, d], 1), k)
            best_i = torch.gather(torch.cat([best_i, i + base + off], 1), 1, pos)
    return best_i.cpu().numpy()


def _recall(got: list, truth) -> float:
    """Mean share of each truth row (ids or keys) found in `got`'s row."""
    return float(np.mean([len(set(g) & set(t)) / len(t) for g, t in zip(got, truth)]))


async def _put_index(http, base, body) -> None:
    async with http.put(base, json=body) as r:
        if r.status != 200:
            raise AssertionError(f"PUT index: {r.status} {await r.text()}")


async def _ingest(http, base, handle, corpus, extra) -> float:
    """Bulk-load `corpus` through the handle and `extra` through POST add;
    returns the seconds until /count reports every row."""
    n = len(corpus)
    t0 = time.perf_counter()
    for off in range(0, n, ADD_BATCH):
        end = min(off + ADD_BATCH, n)
        await handle.add_or_replace_batch([((i,), corpus[i]) for i in range(off, end)])
    for j, row in enumerate(extra):
        payload = {"primary_key": [n + j], "embedding": row.tolist()}
        async with http.post(base + "/add", json=payload) as r:
            if r.status != 200:
                raise AssertionError(f"POST add: {r.status} {await r.text()}")
    await _wait_count(http, base, n + len(extra))
    return time.perf_counter() - t0


async def _wait_count(http, base, want: int) -> None:
    deadline = time.perf_counter() + 900
    while True:
        async with http.get(base + "/count") as r:
            count = await r.json()
        if count == want:
            return
        if time.perf_counter() > deadline:
            raise AssertionError(f"count stuck at {count}, want {want}")
        await asyncio.sleep(0.05)


async def _http_ann(http, base, vecs, limit, lat=None) -> list:
    """POST .../ann for every row of `vecs`, IN_FLIGHT at a time; returns
    the pk0 column of each answer and appends latencies to `lat`."""
    sem = asyncio.Semaphore(IN_FLIGHT)

    async def ann(vec):
        async with sem:
            t = time.perf_counter()
            payload = {"embedding": vec.tolist(), "limit": limit}
            async with http.post(base + "/ann", json=payload) as r:
                if r.status != 200:
                    raise AssertionError(f"POST ann: {r.status} {await r.text()}")
                res = await r.json()
            if lat is not None:
                lat.append(time.perf_counter() - t)
            return res["primary_keys"]["pk0"]

    return await asyncio.gather(*(ann(v) for v in vecs))


async def phase_service(torch, n, device="cuda"):
    import aiohttp

    from vector_store_tpu_torch import IndexId, new_index_factory, run
    from vector_store_tpu_torch.core import ivf_cuda

    t0 = time.perf_counter()
    corpus = make_corpus(n, DIM)
    extra = make_extra(corpus, EXTRA_ROWS)
    queries = make_queries(corpus, N_BATCH)
    log(f"  corpus {n} x {DIM} generated in {time.perf_counter() - t0:.1f} s (host)")

    server, engine = await run("127.0.0.1:0", new_index_factory(device=device))
    out = {}
    try:
        base = f"http://{server.addr}/api/v1/indexes/{KS}/{IX}"
        async with aiohttp.ClientSession() as http:
            await _put_index(http, base, {"dimensions": DIM, "space": "cosine", "dtype": "int8", "kind": "ivf"})
            handle = await engine.get_index(IndexId.from_parts(KS, IX))

            # main path from here: count kernel launches of this run only
            for key in ivf_cuda.LAUNCHES:
                ivf_cuda.LAUNCHES[key] = 0
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            ingest_s = await _ingest(http, base, handle, corpus, extra)
            want = n + EXTRA_ROWS
            out["ingest_vec_s"] = want / ingest_s
            idx = handle.backend.index
            mem = torch.cuda.max_memory_allocated() if device == "cuda" else 0
            log(f"  ingested {want} rows in {ingest_s:.2f} s: {out['ingest_vec_s']:.0f} vec/s; "
                f"{idx.n_clusters} clusters x bucket {idx.state.bucket}; "
                f"peak device memory {mem / 2**30:.3f} GiB")

            # phase 3: queries over HTTP, 64 in flight
            lat = []
            t0 = time.perf_counter()
            got = await _http_ann(http, base, queries[:N_HTTP], 10, lat)
            wall = time.perf_counter() - t0
            lat_ms = np.asarray(lat) * 1e3
            truth = _oracle(torch, corpus, extra, queries, 10, device)
            out["recall_http"] = _recall(got, truth[:N_HTTP])
            out["p50_ms"], out["p99_ms"] = (float(np.percentile(lat_ms, s)) for s in (50, 99))
            out["http_qps"] = N_HTTP / wall
            log(f"  HTTP ann limit=10 x {N_HTTP}, {IN_FLIGHT} in flight: recall@10 "
                f"{out['recall_http']:.4f}; p50 {out['p50_ms']:.2f} ms  p99 "
                f"{out['p99_ms']:.2f} ms; {out['http_qps']:.1f} req/s")
            if out["recall_http"] < MIN_RECALL:
                raise AssertionError(f"recall@10 {out['recall_http']} < {MIN_RECALL}")
            fused_http = ivf_cuda.LAUNCHES["search_fused"]

            big = await _http_ann(http, base, queries[:8], 50)
            if any(len(b) != 50 for b in big):
                raise AssertionError("limit=50 queries returned short lists")
            out["launches"] = dict(ivf_cuda.LAUNCHES)
            log(f"  HTTP ann limit=50 x 8: ok; launches on the HTTP path: {out['launches']}")
            if device == "cuda" and not (fused_http > 0 and out["launches"]["pool_scan"] > 0):
                raise AssertionError(f"a kernel was not launched: {out['launches']}")

            # batch: IvfIndex.search on 2,048 queries in one call
            idx.search(queries, 10)
            times = []
            for _ in range(3):
                t = time.perf_counter()
                _, ids = idx.search(queries, 10)
                times.append(time.perf_counter() - t)
            out["batch_qps"] = N_BATCH / float(np.median(times))
            out["recall_batch"] = _recall([r.tolist() for r in ids], truth)
            log(f"  IvfIndex.search {N_BATCH} queries in one call: {out['batch_qps']:.0f} QPS "
                f"(median of 3); recall@10 {out['recall_batch']:.4f}")
            if device == "cuda":  # B1 at the HTTP batch shape: 64 queries, this index, p 16
                st = idx.state
                rid_m, nsb_m = ivf_cuda.scan_masks(st)
                qf, cids, _ = ivf_cuda.route(
                    st, torch.as_tensor(queries[:64], device=device), "cosine", 16)
                out["b1_http"] = b1_shape(
                    torch, "HTTP batch (64 queries, p 16)", st.vectors, st.scales, rid_m, qf,
                    cids, nsb_m)
    finally:
        await server.close()
        await engine.close()
    out["bench_geometry"], geo_idx, geo_truth = reference_geometry(torch, corpus, queries, device)
    out["data"] = (corpus, extra, queries, truth)  # phase 13 serves the same rows sharded
    return out, (geo_idx, queries, geo_truth)


def reference_geometry(torch, corpus, queries, device, rpb=340, probes=2):
    """Recall at the JAX package's recorded bench geometry: one add() into
    an index sized for the corpus (a single recluster over every row),
    rows per bucket 340, probes 2.  Returns (numbers, the index, the exact
    top-10 of `queries`): phases 7 and 8 measure on the same index."""
    from vector_store_tpu_torch import IndexParams
    from vector_store_tpu_torch.core.ivf import IvfIndex

    idx = IvfIndex(
        IndexParams(dimensions=DIM, space="cosine", dtype="int8"),
        initial_capacity=len(corpus),
        rows_per_bucket=rpb,
        device=device,
    )
    t0 = time.perf_counter()
    idx.add(corpus)
    add_s = time.perf_counter() - t0
    truth = _oracle(torch, corpus, corpus[:0], queries, 10, device)
    _, ids = idx.search(queries, 10, probes=probes)
    rec = _recall([r.tolist() for r in ids], truth)
    log(f"  bench geometry (one add, rows/bucket {rpb}, {idx.n_clusters} clusters x bucket "
        f"{idx.state.bucket}): add {len(corpus) / add_s:.0f} vec/s; "
        f"recall@10 at probes={probes}: {rec:.4f}")
    return {"recall_p2": rec, "add_vec_s": len(corpus) / add_s}, idx, truth


# --------------------------------------------------------------------------
# phases 4-6: the graph backend


# (Q, beam, degree) of the graph's expand rounds: the search shape (beam 4 x
# degree 32) and the insert shape (insert_cfg: beam 16 x degree 32, blocks
# of 1,024 rows)
GRAPH_SHAPES = {"search": (256, 4, 32), "insert": (1024, 16, 32)}


def distinct_rows(torch, ids) -> tuple[int, int]:
    """(distinct candidate ids per query, candidate ids), ids other than
    SENTINEL, summed over the batch: the rows B3 reads with its per-query
    dedup, and without it."""
    from vector_store_tpu_torch.core.topk import SENTINEL

    s = torch.sort(ids, dim=1)[0]
    valid = s != SENTINEL
    new = valid.clone()
    new[:, 1:] &= s[:, 1:] != s[:, :-1]
    return int(new.sum()), int(valid.sum())


def distinct_share(torch, ids) -> float:
    """The share of a batch's candidate rows a per-query dedup still reads."""
    distinct, total = distinct_rows(torch, ids)
    return distinct / max(total, 1)


def b3_check(torch, vec, scl, q, cand, nbrs, sel, live, device) -> float:
    """Both B3 entry points against their plain versions in every space:
    ids equal, INF where the plain version has INF; returns max |d err|."""
    from vector_store_tpu_torch.core import graph_cuda as gc

    err = 0.0
    for space in ("cosine", "dot", "l2"):
        d_k = gc.gather_score_fused(vec, scl, q, cand, space)
        d_p = gc.gather_score_plain(vec, scl, q, cand, space)
        i_k, e_k = gc.expand_score_fused(vec, scl, nbrs, q, sel, live, space)
        i_p, e_p = gc.expand_score_plain(vec, scl, nbrs, q, sel, live, space)
        _sync(torch, device)
        if not torch.equal(i_k, i_p) or not torch.equal(torch.isinf(e_k), torch.isinf(e_p)):
            raise AssertionError(f"B3 expand: ids or INF pattern differ ({space})")
        fin = torch.isfinite(e_p)
        err = max(err, float((d_k - d_p).abs().max()), float((e_k - e_p)[fin].abs().max()))
    return err


def b3_timing(torch, label, vec, scl, q, cand, nbrs, sel, live) -> dict:
    """B3's two entry points at one shape, cosine, cold L2, in turns, each
    beside its plain version and its bound, and the rate at which it reads
    the rows it does read (each query's distinct candidates: the dedup is
    per query, so a row two queries share is read twice); and the distinct
    share of the expand entry's candidates.  Returns {"gather"|"expand":
    (ms, plain_ms, bound_ms, bound_by), "distinct": share}."""
    from vector_store_tpu_torch.core import graph_cuda as gc
    from vector_store_tpu_torch.core.topk import SENTINEL

    Q, BR = cand.shape
    D = vec.shape[1]
    row_bytes = D * vec.element_size() + (4 if vec.dtype == torch.int8 else 0)
    ids = gc.expand_score_plain(vec, scl, nbrs, q, sel, live, "cosine")[0]
    valid = ids[ids != SENTINEL]
    adj = int(torch.unique(sel[live]).numel()) * nbrs.shape[1] * 4
    work = {
        # distinct candidate rows read once, the queries, the ids in, the distances out
        "gather": (int(torch.unique(cand).numel()) * row_bytes + Q * D * 4 + 2 * Q * BR * 4,
                   2 * D * Q * BR),
        # distinct live candidate rows, the adjacency rows of the distinct
        # live selected nodes, sel_ids and sel_live, the queries, ids and
        # distances out
        "expand": (int(torch.unique(valid).numel()) * row_bytes + adj + sel.numel() * 5
                   + Q * D * 4 + 2 * ids.numel() * 4, 2 * D * valid.numel()),
    }
    calls = {
        "gather": (lambda: gc.gather_score_fused(vec, scl, q, cand, "cosine"),
                   lambda: gc.gather_score_plain(vec, scl, q, cand, "cosine")),
        "expand": (lambda: gc.expand_score_fused(vec, scl, nbrs, q, sel, live, "cosine"),
                   lambda: gc.expand_score_plain(vec, scl, nbrs, q, sel, live, "cosine")),
    }
    read = {"gather": distinct_rows(torch, cand)[0], "expand": distinct_rows(torch, ids)[0]}
    out = {}
    for name, (kern, plain) in calls.items():
        t = _turns(torch, {"plain": plain, "kernel": kern}, {"plain": 3, "kernel": 20})
        bound, by = _bound(*work[name], F32_CORES)
        ms = t["kernel"][0]
        out[name] = (ms, t["plain"][0], bound, by)
        gbs = read[name] * row_bytes / (ms * 1e-3) / 1e9
        log(f"  B3 {name:6s} {label}, cold L2: kernel {_fmt(t['kernel'])}, plain "
            f"{_fmt(t['plain'])}; bound {bound:.4f} ms ({by}), share {bound / ms:.3f}; "
            f"{read[name]} rows read (per-query distinct) at {gbs:.1f} GB/s")
    out["distinct"] = distinct_share(torch, ids)
    return out


def _graph_case(torch, gen, C, Q, B, R, device):
    """Synthetic inputs of one expand round: queries, candidate ids with
    repeats, an adjacency with SENTINEL padding (every 7th row's second
    half), selected nodes with a tenth of the beams dead and each query's
    first two beams on the same node."""
    from vector_store_tpu_torch.core.distance import normalize
    from vector_store_tpu_torch.core.topk import SENTINEL

    D = DIM
    q = normalize(torch.randn((Q, D), generator=gen, device=device))
    cand = torch.randint(0, C, (Q, B * R), generator=gen, device=device, dtype=torch.int32)
    cand[:, B * R - B * R // 16 :] = cand[:, : B * R // 16]  # repeated ids
    nbrs = torch.randint(0, C, (C, R), generator=gen, device=device, dtype=torch.int32)
    nbrs[::7, R // 2 :] = SENTINEL
    sel = torch.randint(0, C, (Q, B), generator=gen, device=device, dtype=torch.int32)
    sel[:, 1] = sel[:, 0]
    live = torch.rand((Q, B), generator=gen, device=device) >= 0.1
    return q, cand.contiguous(), nbrs, sel, live


def phase_graph_kernels(torch, device="cuda", C=2 * N_GRAPH, D=DIM, shapes=None):
    """B3 against its plain versions on a [C, D] bank of unit-norm rows
    (f32, bf16, int8; cosine, dot, l2) at the search and insert shapes:
    the ids-given entry with repeated ids, the expand entry with dead
    beams, SENTINEL padding and repeated nodes.  On the card, each entry's
    time (cold L2, in turns) beside its bound.  Returns (max |d err|,
    {(dtype, shape): timing}).
    The tolerance is TOL for every space: l2 adds |q|^2 + |x|^2 terms near
    1, which f32 holds to ~1e-7."""
    from vector_store_tpu_torch.core.distance import normalize
    from vector_store_tpu_torch.core.quantize import quantize_rows

    shapes = shapes or GRAPH_SHAPES
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    rows = normalize(torch.randn((C, D), generator=gen, device=device))
    cases = {name: _graph_case(torch, gen, C, *shape, device) for name, shape in shapes.items()}
    err, timing = 0.0, {}
    for dt in ("float32", "bfloat16", "int8"):
        if dt == "int8":
            vec, scl = quantize_rows(rows)
        else:
            vec, scl = rows.to(getattr(torch, dt)), torch.ones((C,), device=device)
        for name, (q, cand, nbrs, sel, live) in cases.items():
            e = b3_check(torch, vec, scl, q, cand, nbrs, sel, live, device)
            err = max(err, e)
            log(f"  B3 {dt:8s} {name:6s} (cosine, dot, l2; both entries): max|d err| {e:.3e}, "
                f"expand ids equal")
            if device == "cuda":
                timing[(dt, name)] = b3_timing(torch, f"{dt} {name} Q={len(q)} "
                                               f"BR={cand.shape[1]}", vec, scl, q, cand,
                                               nbrs, sel, live)
        del vec, scl
    if err > TOL:
        raise AssertionError(f"B3 disagrees with its plain version: max|d err| {err}")
    del rows, cases
    if device == "cuda":
        torch.cuda.empty_cache()
    return err, timing


def _sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def _slot_truth(backend, queries, k=10) -> list:
    """Exact top-k keys (pk0) over the backend's live bank."""
    _, slots = backend.index.exact_search(queries, k)
    return [[backend.keymap.key_of(int(s))[0] for s in row if s >= 0] for row in slots]


async def phase_graph_service(torch, n=N_GRAPH, device="cuda", n_remove=N_REMOVE):
    """A kind-"ann" index over HTTP: ingest, queries, remove, compact."""
    import aiohttp

    from vector_store_tpu_torch import IndexId, new_index_factory, run
    from vector_store_tpu_torch.core import graph_cuda

    corpus = make_corpus(n, DIM)
    extra = make_extra(corpus, EXTRA_ROWS)
    queries = make_queries(corpus, N_HTTP)
    server, engine = await run("127.0.0.1:0", new_index_factory(device=device))
    out = {}
    try:
        base = f"http://{server.addr}/api/v1/indexes/{KS}/{GIX}"
        async with aiohttp.ClientSession() as http:
            # kind and dtype left to the route's defaults: "ann", bfloat16
            await _put_index(http, base, {"dimensions": DIM, "space": "cosine", "capacity": n})
            handle = await engine.get_index(IndexId.from_parts(KS, GIX))
            backend = handle.backend
            idx = backend.index
            if type(idx).__name__ != "SlotIndex" or idx.cfg.dtype != "bfloat16":
                raise AssertionError(f"PUT made {type(idx).__name__} {idx.cfg.dtype}")

            # main path from here: B3 launches of this run only
            for key in graph_cuda.LAUNCHES:
                graph_cuda.LAUNCHES[key] = 0
            ingest_s = await _ingest(http, base, handle, corpus, extra)
            want = n + len(extra)
            out["ingest_vec_s"] = want / ingest_s
            out["launches_ingest"] = graph_cuda.LAUNCHES["expand_score"]
            log(f"  ingested {want} rows in {ingest_s:.2f} s: {out['ingest_vec_s']:.0f} vec/s; "
                f"capacity {idx.capacity}, routing sample {idx.cfg.routing_sample}; "
                f"B3 launches {out['launches_ingest']}")

            graph_cuda.LAUNCHES["expand_score"] = 0
            lat = []
            t0 = time.perf_counter()
            got = await _http_ann(http, base, queries, 10, lat)
            wall = time.perf_counter() - t0
            out["launches_query"] = graph_cuda.LAUNCHES["expand_score"]
            lat_ms = np.asarray(lat) * 1e3
            out["recall_http"] = _recall(got, _slot_truth(backend, queries))
            out["p50_ms"], out["p99_ms"] = (float(np.percentile(lat_ms, s)) for s in (50, 99))
            out["http_qps"] = len(queries) / wall
            log(f"  HTTP ann limit=10 x {len(queries)}, {IN_FLIGHT} in flight: recall@10 "
                f"{out['recall_http']:.4f} (vs exact_search, bf16 bank); p50 {out['p50_ms']:.2f} ms  "
                f"p99 {out['p99_ms']:.2f} ms; {out['http_qps']:.1f} req/s; B3 launches "
                f"{out['launches_query']}")
            if device == "cuda" and not (out["launches_ingest"] > 0 and out["launches_query"] > 0):
                raise AssertionError(f"B3 was not launched: {out}")
            out["rounds"] = graph_observe(torch, "service graph (bf16)", idx, queries,
                                          make_extra(corpus, 1024, seed=SEED + 5))

            removed = set(range(0, n, max(n // n_remove, 1))[:n_remove])
            sem = asyncio.Semaphore(IN_FLIGHT)

            async def remove(key):
                async with sem:
                    async with http.post(base + "/remove", json={"primary_key": [key]}) as r:
                        if r.status != 200:
                            raise AssertionError(f"POST remove: {r.status} {await r.text()}")

            await asyncio.gather(*(remove(k) for k in removed))
            await _wait_count(http, base, want - len(removed))
            for stage in ("removed", "compacted"):
                if stage == "compacted":
                    async with http.post(base + "/compact") as r:
                        count = (await r.json())["count"]
                    if count != want - len(removed) or idx.frontier != count:
                        raise AssertionError(f"compact: count {count}, frontier {idx.frontier}")
                got = await _http_ann(http, base, queries, 10)
                back = sum(k in removed for g in got for k in g)
                rec = _recall(got, _slot_truth(backend, queries))
                out[f"recall_{stage}"] = rec
                log(f"  after {len(removed)} removes{' + compact' if stage == 'compacted' else ''}: "
                    f"recall@10 {rec:.4f}; removed keys returned: {back}")
                if back:
                    raise AssertionError(f"{back} removed keys came back")
            for key in ("recall_http", "recall_removed", "recall_compacted"):
                if out[key] < MIN_RECALL:
                    raise AssertionError(f"{key} {out[key]} < {MIN_RECALL}")
    finally:
        await server.close()
        await engine.close()
    return out


def graph_geometry(torch, n=N_GRAPH, device="cuda"):
    """The JAX package's recorded graph geometry (bench.py:991-998): f32,
    cosine, one add() into an index sized for the corpus, insert blocks of
    1,024, ef 64, k 10; then one router rebuild at route_k_for(n)."""
    from vector_store_tpu_torch import IndexParams
    from vector_store_tpu_torch.core import cluster
    from vector_store_tpu_torch.core.index import SlotIndex

    corpus = make_corpus(n, DIM)
    queries = make_queries(corpus, N_BATCH)
    idx = SlotIndex(
        IndexParams(dimensions=DIM, space="cosine", capacity=n),
        initial_capacity=n,
        insert_block=1024,
        device=device,
    )
    t0 = time.perf_counter()
    idx.add(corpus)
    _sync(torch, device)
    add_s = time.perf_counter() - t0
    _, truth = idx.exact_search(queries, 10)
    idx.search(queries, 10)
    times = []
    for _ in range(3):
        t = time.perf_counter()
        _, ids = idx.search(queries, 10)
        times.append(time.perf_counter() - t)
    out = {
        "add_vec_s": n / add_s,
        "batch_qps": N_BATCH / float(np.median(times)),
        "recall": _recall([r.tolist() for r in ids], truth),
    }
    log(f"  recorded geometry ({n} x {DIM} f32, one add, insert block 1024, capacity "
        f"{idx.capacity}): add {out['add_vec_s']:.0f} vec/s; SlotIndex.search {N_BATCH} queries "
        f"in one call {out['batch_qps']:.0f} QPS (median of 3); recall@10 at ef "
        f"{idx.cfg.ef_search}: {out['recall']:.4f} (TPU record {TPU_RECALL_GEOMETRY})")
    if out["recall"] < MIN_RECALL_GEOMETRY:
        raise AssertionError(f"recall@10 {out['recall']} < {MIN_RECALL_GEOMETRY}")
    extra = make_extra(corpus, 1024, seed=SEED + 6)
    out["rounds"] = graph_observe(torch, "recorded geometry (f32)", idx, queries[:256], extra,
                                  captured=device == "cuda")

    k = cluster.route_k_for(idx.frontier)
    t0 = time.perf_counter()
    with idx._lock:  # a forced rebuild below ROUTE_MIN_ROWS
        idx._rebuild_router_locked(idx.frontier, k)
    _sync(torch, device)
    build_s = time.perf_counter() - t0
    _, ids = idx.search(queries, 10)
    out["recall_routed"] = _recall([r.tolist() for r in ids], truth)
    log(f"  router rebuilt with {k} centroids in {build_s:.2f} s; recall@10 through routed "
        f"entries: {out['recall_routed']:.4f}")
    if device == "cuda":  # one more insert block, with the index's own add()
        from vector_store_tpu_torch.core import graph_cuda as gc

        names = []
        before = gc.LAUNCHES["expand_score"]
        out["insert_block_ops"] = _count_kernels(torch, lambda: idx.add(extra), names)
        b3 = sum("graph_score_kernel" in name for name in names)
        launched = (gc.LAUNCHES["expand_score"] - before) // 2  # a warm-up call, then the counted one
        log(f"  one insert block (1,024 rows, add()): {out['insert_block_ops']} device operations "
            f"as the profiler records them, {b3} of them B3 (B3 launches by its count: "
            f"{launched})")
    return out, idx, queries


def graph_rounds(torch, idx, queries, insert=False, capture=None):
    """search_pool's rounds on a SlotIndex's graph, observed: the distinct
    share of each round's candidates (distinct_share) and, for round
    `capture`, (queries_f32, sel_ids, sel_live).  insert: the insert-time
    search (build.insert_cfg) with `queries` as a block of new rows; the
    graph is not changed."""
    from vector_store_tpu_torch.core import build, search
    from vector_store_tpu_torch.core import graph_cuda as gc
    from vector_store_tpu_torch.core.distance import preprocess
    from vector_store_tpu_torch.core.topk import merge_pool, merge_pool_fast

    cfg = build.insert_cfg(idx.cfg) if insert else idx.cfg
    merge = merge_pool_fast if cfg.approx_topk else merge_pool
    shares, captured = [], None
    with idx._lock:
        st = idx._state
        q = torch.as_tensor(np.asarray(queries, np.float32), device=idx.device)
        q = preprocess(q, cfg.space).to(cfg.compute_dtype)
        qf = q.float().contiguous()
        pool = search._init_pool(st, q, cfg)
        for r in range(cfg.search_iters):
            sel_ids, sel_live, pool_exp = search.select_frontier(pool, cfg.beam_width)
            if r == capture:
                captured = (qf, sel_ids.clone(), sel_live.clone())
            ids, dist = gc.expand_score_fused(st.vectors, st.scales, st.neighbors, qf, sel_ids,
                                              sel_live, cfg.space)
            shares.append(distinct_share(torch, ids))
            pool = merge(pool[0], pool[1], pool_exp, dist, ids)
    return shares, captured, cfg


def graph_observe(torch, label, idx, queries, block, captured=False) -> dict:
    """On a built graph: the distinct share of each expand round's
    candidates for a search of `queries` and for the insert-time search of
    `block`; device operations of one SlotIndex.search of 256 queries; with
    `captured`, the middle round of each, held and timed on the card as
    phase 4 does (the graph's bank, and its bf16 and int8 copies)."""
    from vector_store_tpu_torch.core import build
    from vector_store_tpu_torch.core import graph_cuda as gc
    from vector_store_tpu_torch.core.quantize import quantize_rows

    out = {}
    dev = idx.device.type
    caps = {}
    for name, q, insert in (("search", queries, False), ("insert", block, True)):
        iters = (build.insert_cfg(idx.cfg) if insert else idx.cfg).search_iters
        shares, cap, cfg = graph_rounds(torch, idx, q, insert, capture=iters // 2)
        caps[name] = (cap, cfg)
        total = float(np.mean(shares))
        out[f"distinct_{name}"] = (total, shares)
        log(f"  {label}, {name} ({len(q)} queries, beam {cfg.beam_width} x degree "
            f"{cfg.degree}, {cfg.search_iters} rounds): distinct candidate share per round "
            + " ".join(f"{x:.3f}" for x in shares) + f"; mean {total:.3f}")
    if dev == "cuda":
        names = []
        before = gc.LAUNCHES["expand_score"]
        out["search_ops"] = _count_kernels(torch, lambda: idx.search(queries[:256], 10), names)
        b3 = sum("graph_score_kernel" in name for name in names)
        launched = (gc.LAUNCHES["expand_score"] - before) // 2  # a warm-up call, then the counted one
        log(f"  {label}: one SlotIndex.search of 256 queries runs {out['search_ops']} device "
            f"operations as the profiler records them, {b3} of them B3 (B3 launches by its "
            f"count: {launched}, one per expand round)")
    if not captured:
        return out
    st = idx._state
    rows = st.vectors.float()
    for name, ((qf, sel, live), cfg) in caps.items():
        for dt in ("float32", "bfloat16", "int8"):
            if dt == "int8":
                vec, scl = quantize_rows(rows)
            elif getattr(torch, dt) == st.vectors.dtype:
                vec, scl = st.vectors, st.scales
            else:
                vec, scl = rows.to(getattr(torch, dt)), torch.ones_like(st.scales)
            ids = gc.expand_score_plain(vec, scl, st.neighbors, qf, sel, live, cfg.space)[0]
            cand = ids.clamp(0, st.capacity - 1).contiguous()
            err = b3_check(torch, vec, scl, qf, cand, st.neighbors, sel, live, dev)
            lab = f"{dt} captured {name} round Q={len(qf)} BR={ids.shape[1]}"
            log(f"  B3 {lab}: max|d err| {err:.3e} (cosine, dot, l2; both entries), ids equal")
            if err > TOL:
                raise AssertionError(f"B3 on a captured round disagrees: {err}")
            out[(dt, name)] = b3_timing(torch, lab, vec, scl, qf, cand, st.neighbors, sel, live)
            del vec, scl
    del rows
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phases 7-9: the IVF measurement path


MODES = ("qi8", "bf16", "stub")
# qi8: exact integer dots and the same f32 product chain as the plain
# version; bf16: the bf16 query's digits, ~1e-8 of a distance; stub: one
# product
MODE_TOL = {"qi8": 0.0, "bf16": TOL, "stub": 0.0}


def phase_modes(torch, device="cuda", Q=256, p=16, B=640, D=DIM, K=512):
    """B1's qi8, bf16 and stub modes against their plain versions at phase
    1's shapes on an int8 bank (cosine and dot; k 10 and 32), the stub also
    on bf16 and f32 banks (phase 1 holds the f32 mode on all three), then
    each mode's time (cosine, k 10; plain, kernel, kernel, plain)."""
    from vector_store_tpu_torch.core import ivf_cuda as ic

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    rid, nsb, q, cids, _ = _scan_case(torch, gen, Q, p, B, D, K, device)
    vec, scl = _bank(torch, "int8", K, B, D, gen, device)
    report = {}
    for mode in MODES:
        rep = report[mode] = {"err": 0.0, "agree": 1.0}
        for space in ("cosine", "dot"):
            for k in (10, 32):
                d_k, r_k = ic.search_fused(vec, scl, rid, q, cids, space, k, nsb, mode)
                d_p, r_p = ic.search_fused_plain(vec, scl, rid, q, cids, space, k + 1, nsb, mode)
                torch.cuda.synchronize()
                err, agree, n_sep = _compare_topk(torch, d_k, r_k, d_p, r_p, k)
                log(f"  B1 {mode:4s} {space:6s} k={k:2d}: max|d err| {err:.3e}  "
                    f"ids agree {agree:.4f} on {n_sep} separated")
                rep["err"], rep["agree"] = max(rep["err"], err), min(rep["agree"], agree)
        if mode == "stub":
            for dt in ("bfloat16", "float32"):
                bv, bs = _bank(torch, dt, K, B, D, gen, device)
                for k in (10, 32):
                    d_k, r_k = ic.search_fused(bv, bs, rid, q, cids, "cosine", k, nsb, mode)
                    d_p, r_p = ic.search_fused_plain(bv, bs, rid, q, cids, "cosine", k + 1, nsb, mode)
                    torch.cuda.synchronize()
                    err, agree, n_sep = _compare_topk(torch, d_k, r_k, d_p, r_p, k)
                    log(f"  B1 stub {dt} k={k:2d}: max|d err| {err:.3e}  ids agree {agree:.4f} "
                        f"on {n_sep} separated")
                    rep["err"], rep["agree"] = max(rep["err"], err), min(rep["agree"], agree)
                del bv, bs
        if rep["err"] > MODE_TOL[mode] or rep["agree"] < 1.0:
            raise AssertionError(f"B1 {mode}: kernel disagrees with plain: {rep}")
        rep["ms"], rep["plain_ms"] = _turns_ms(
            torch,
            lambda: ic.search_fused(vec, scl, rid, q, cids, "cosine", 10, nsb, mode),
            lambda: ic.search_fused_plain(vec, scl, rid, q, cids, "cosine", 10, nsb, mode),
            50,
            3,
        )
        nbytes, ops = b1_work(torch, rid, nsb, cids, D, 1, 10)
        rep["gbs"] = nbytes / (rep["ms"] * 1e-3) / 1e9
        rep["bound_ms"], rep["bound_by"] = _bound(nbytes, ops, MODE_UNITS[mode])
        log(f"  B1 {mode}: kernel {rep['ms']:.4f} ms  plain {rep['plain_ms']:.4f} ms  "
            f"({rep['plain_ms'] / rep['ms']:.1f}x; {rep['gbs']:.1f} GB/s of bytes moved once, "
            f"Q={Q} p={p} B={B} D={D}); bound {rep['bound_ms']:.4f} ms ({rep['bound_by']}), "
            f"share {rep['bound_ms'] / rep['ms']:.3f}")
    del vec, scl
    torch.cuda.empty_cache()
    return report


def bench_rates(torch, geo, Q=256, p=16):
    """B1 (f32) and B2 in GB/s on the bench-geometry index (an int8 bank of
    over 1 GiB, far past the 50 MB L2) at phase 1's Q and p: the first Q
    queries routed to their p clusters, cosine, k 10.  The bytes are those
    the call must move once (b1_work, the bound's: each distinct probed
    bucket's live rows once, since the kernels read a bucket once per tile
    and not once per probe; queries, cids and outputs once), so a rate
    cannot pass the card's copy rate.  `distinct` is the share of the
    probed rows, counted per probe, that lie in distinct buckets.  These
    are the rates held against B4's in phase 9.  Before them, B1 in every
    mode at this shape and at the bench geometry's own (1,024 queries,
    probes 2)."""
    from vector_store_tpu_torch.core import ivf_cuda as ic

    idx, queries, _ = geo
    st = idx.state
    rid, nsb = ic.scan_masks(st)
    shapes = {}
    cases = (("bench index Q=256 p=16", Q, p), ("bench geometry Q=1024 p=2", 1024, 2))
    for label, qn, pn in cases if idx.device.type == "cuda" else ():
        qq, cc, _ = ic.route(st, torch.as_tensor(queries[:qn], device=idx.device), "cosine", pn)
        shapes[label] = b1_shape(torch, label, st.vectors, st.scales, rid, qq, cc, nsb)
    q, cids, p = ic.route(st, torch.as_tensor(queries[:Q], device=idx.device), "cosine", p)
    live = st.valid.sum(dim=1)
    rows_read = int(live[cids.long()].sum())
    out = {
        "bank_gib": st.vectors.numel() / 2**30,
        "distinct": int(live[torch.unique(cids.long())].sum()) / rows_read,
        "b1_shapes": shapes,
    }
    runs = {
        "search_fused": lambda: ic.search_fused(
            st.vectors, st.scales, rid, q, cids, "cosine", 10, nsb),
        "pool_scan": lambda: ic.pool_scan_fused(
            st.vectors, st.scales, rid, q, cids, "cosine", False, nsb),
    }
    for name, fn in runs.items():
        ms = _time_ms(torch, fn, 50)
        nbytes, _ = b1_work(torch, rid, nsb, cids, DIM, 1, 10, pool_out=name == "pool_scan")
        out[name] = (ms, nbytes / (ms * 1e-3) / 1e9)
        log(f"  {name} on the bench-geometry index ({out['bank_gib']:.3f} GiB), Q={Q} p={p}: "
            f"{ms:.4f} ms, {out[name][1]:.1f} GB/s of the {nbytes / 1e6:.1f} MB it must move once "
            f"({rows_read} rows probed, {out['distinct']:.3f} of them in distinct buckets)")
    if idx.device.type == "cuda":
        # B2 in turns (cold L2) on this index at this shape and at the
        # bench geometry's own (probes 2), int8 and packed int4 (the
        # two-stage scan's coarse bank)
        for label, qn, pn in cases:
            qq, cc, _ = ic.route(st, torch.as_tensor(queries[:qn], device=idx.device), "cosine", pn)
            banks = {"int8": (st.vectors, st.scales)}
            out[f"b2 {label}"] = b2_timing(torch, label, banks, rid, nsb, qq, cc)
    return out


def modes_recall(torch, geo, probes=2):
    """recall@10 of each B1 mode on the bench-geometry index (2,048 queries
    in chunks of 256, the IvfIndex's chunk), the measurement path's run:
    the per-mode launch counts are read from it alone."""
    from vector_store_tpu_torch.core import ivf_cuda as ic
    from vector_store_tpu_torch.core.ivf import QCHUNK

    idx, queries, truth = geo
    st = idx.state
    masks = ic.scan_masks(st)
    for key in ic.SCORE_LAUNCHES:
        ic.SCORE_LAUNCHES[key] = 0
    recall = {}
    for mode in MODES:
        ids = []
        for off in range(0, len(queries), QCHUNK):
            q = torch.as_tensor(queries[off : off + QCHUNK], device=idx.device)
            ids.append(ic.search_clustered_fused(st, q, "cosine", 10, probes, masks, mode)[1])
        ids = torch.cat(ids).cpu().numpy()
        recall[mode] = _recall([r.tolist() for r in ids], truth)
    launches = dict(ic.SCORE_LAUNCHES)
    log(f"  recall@10 at the bench geometry, probes {probes}: "
        + ", ".join(f"{m} {recall[m]:.4f}" for m in MODES) + f"; launches {launches}")
    if idx.device.type == "cuda" and any(launches[m] == 0 for m in MODES):
        raise AssertionError(f"a B1 mode was not launched: {launches}")
    return recall, launches


def phase_two_stage(torch, geo, probes_list=(2, 4)):
    """IvfIndex(coarse=True) semantics on the bench-geometry index: the
    derive time, recall@10 and batch QPS (2,048 queries in one call, median
    of 3) at each probe count beside the single-stage scan, B2 packed
    launches; then a save -> load round trip in a temporary directory."""
    import tempfile

    from vector_store_tpu_torch.core import ivf_cuda as ic
    from vector_store_tpu_torch.core.ivf import IvfIndex, derive_coarse

    idx, queries, truth = geo

    def batch(p):
        idx.search(queries, 10, probes=p)
        times = []
        for _ in range(3):
            t = time.perf_counter()
            _, ids = idx.search(queries, 10, probes=p)
            times.append(time.perf_counter() - t)
        return N_BATCH / float(np.median(times)), _recall([r.tolist() for r in ids], truth)

    out = {"single": {p: batch(p) for p in probes_list}}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    coarse = derive_coarse(idx.state.vectors)
    end.record()
    torch.cuda.synchronize()
    out["derive_s"] = start.elapsed_time(end) / 1e3
    log(f"  derive_coarse: {out['derive_s']:.3f} s for {coarse.numel() >> 20} MB of packed bank")
    del coarse

    # main path from here: the two-stage search's kernel launches
    idx.coarse = True  # nothing mutates the index while it is switched
    for key in ic.LAUNCHES:
        ic.LAUNCHES[key] = 0
    out["two"] = {p: batch(p) for p in probes_list}
    out["launches"] = dict(ic.LAUNCHES)
    for p in probes_list:
        (qs, rs), (qt, rt) = out["single"][p], out["two"][p]
        log(f"  probes {p}: two-stage recall@10 {rt:.4f} at {qt:.0f} QPS; single-stage "
            f"{rs:.4f} at {qs:.0f} QPS (cand {max(idx.rescore * 10, 64)})")
    log(f"  launches of the two-stage runs: {out['launches']}")
    cuda = idx.device.type == "cuda"
    if cuda and (out["launches"]["pool_scan"] == 0 or out["launches"]["search_fused"] != 0):
        raise AssertionError(f"two-stage did not run B2 packed alone: {out['launches']}")
    if out["two"][2][1] < out["single"][2][1] - 0.02:
        raise AssertionError(f"two-stage recall {out['two'][2][1]} vs {out['single'][2][1]}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ivf.npz")
        t = time.perf_counter()
        idx.save(path)
        out["save_s"] = time.perf_counter() - t
        size = os.path.getsize(path)
        t = time.perf_counter()
        back = IvfIndex.load(path, device=idx.device)
        _sync(torch, idx.device.type)
        out["load_s"] = time.perf_counter() - t
        for coarse in (True, False):
            idx.coarse = back.coarse = coarse
            _, a = idx.search(queries, 10, probes=2)
            _, b = back.search(queries, 10, probes=2)
            if not np.array_equal(a, b):
                raise AssertionError(f"the loaded index answers differently (coarse={coarse})")
        del back
    idx.coarse = False
    log(f"  snapshot round trip: save {out['save_s']:.2f} s, load {out['load_s']:.2f} s "
        f"({size / 2**30:.3f} GiB npz); loaded index returns the same ids, two-stage and single")
    return out


def phase_copy_probe(torch, device="cuda"):
    """B4 against its plain version on a small bank (2 groups of 64 blocks
    of 384 x 768), then its GB/s over a >= 1 GiB bank at each block size,
    score on and off (the measurement path: launches counted there), and
    kernel vs plain time at B=128, score on."""
    from vector_store_tpu_torch.probes import dma

    q = dma.make_query(DIM, device)
    small = dma.make_bank(2 * dma.GROUP * 384 * DIM, device, seed=2).view(-1, 384, DIM)
    err = {"abs": 0.0, "rel": 0.0}
    for score in (True, False):
        got, want = dma.stream(q, small, score), dma.stream_plain(q, small, score)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err["abs"] = max(err["abs"], float(diff.max()))
        err["rel"] = max(err["rel"], float((diff / want.abs().clamp(min=1e-30)).max()))
        log(f"  B4 score={int(score)}: kernel {got[0, :2].tolist()} plain {want[0, :2].tolist()}")
    if err["rel"] > 1e-4:
        raise AssertionError(f"B4 disagrees with its plain version: {err}")
    del small

    flat = dma.make_bank(dma.bank_bytes(1 << 30, DIM), device)
    dma.LAUNCHES["stream"] = 0
    rows = dma.sweep(flat, q, reps=20)
    launches = dma.LAUNCHES["stream"]
    for r in rows:
        log(f"  B4 B={r['B']:5d} score={int(r['score'])}: {r['gbs']:.1f} GB/s "
            f"({r['ms']:.4f} ms per {flat.numel() / 2**30:.3f} GiB; slope {r['slope_gbs']:.1f} GB/s)")
    bank = flat.view(-1, 128, DIM)
    ms, plain_ms = _turns_ms(
        torch, lambda: dma.stream(q, bank, True), lambda: dma.stream_plain(q, bank, True), 20, 2
    )
    # the bank read once; 2*D f32 operations per row (score on)
    bound, by = _bound(bank.numel() + q.numel() * 4 + 32, 2 * bank.numel(), F32_CORES)
    del flat, bank
    torch.cuda.empty_cache()
    log(f"  B4 B=128 score=1: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms; max rel err "
        f"{err['rel']:.3e} (abs {err['abs']:.3e}); launches {launches}; bound {bound:.4f} ms "
        f"({by}), share {bound / ms:.3f}")
    if device == "cuda" and launches == 0:
        raise AssertionError("B4 was not launched")
    return {"rows": rows, "err": err, "launches": launches, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by}


# --------------------------------------------------------------------------
# phase 10: text search


TEXT_K1, TEXT_B = 1.2, 0.75
TEXT_TOL = 1e-4  # relative: f32 scores on the device against the f64 oracle
N_TEXT_HTTP, N_TEXT, N_TEXT_CPU = 2000, 100_000, 10_000
TEXT_VOCAB, TEXT_WORDS = 20_000, 24
TEXT_MAX_BYTES = 8 << 30


def _term_id(word: str) -> int:
    """FNV-1a 32-bit folded into [1, 2^22): the index's hashed vocabulary."""
    h = 0x811C9DC5
    for b in word.encode("utf-8"):
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h % ((1 << 22) - 1) + 1


class TextOracle:
    """A straightforward numpy BM25 over the live documents (the oracle of
    tests/test_bm25.py, vectorised): k1 1.2, b 0.75, idf = ln(1 + (n - df +
    0.5) / (df + 0.5)) over live documents, tokens [a-z0-9]+ of the
    lowercased text, hashed as the index hashes them.  Scores in f64."""

    def __init__(self):
        self.docs = {}  # key -> token ids in order
        self.words = {}  # word -> term id, every word ever added
        self._m = None

    def put(self, key, text):
        words = re.findall(r"[a-z0-9]+", text.lower())
        for w in words:
            if w not in self.words:
                self.words[w] = _term_id(w)
        self.docs[key] = [self.words[w] for w in words]
        self._m = None

    def put_rows(self, keys, rows, table):
        """Documents given as rows of word numbers; `table[w]` is the id."""
        self._m = (list(keys), table[rows], np.full(len(rows), rows.shape[1], dtype=np.int64))

    def remove(self, key):
        self.docs.pop(key, None)
        self._m = None

    def matrix(self):
        if self._m is None:
            keys = list(self.docs)
            width = max(len(d) for d in self.docs.values())
            m = np.zeros((len(keys), width), dtype=np.int64)
            for j, k in enumerate(keys):
                m[j, : len(self.docs[k])] = self.docs[k]
            self._m = (keys, m, np.array([len(self.docs[k]) for k in keys]))
        return self._m

    def df(self, term: int) -> int:
        return int((self.matrix()[1] == term).any(1).sum())

    def scores(self, terms) -> np.ndarray:
        _, m, length = self.matrix()
        n = len(m)
        norm = TEXT_K1 * (1.0 - TEXT_B + TEXT_B * length / max(length.sum() / n, 1.0))
        out = np.zeros(n)
        for t in dict.fromkeys(terms):
            tf = (m == t).sum(1)
            df = int((tf > 0).sum())
            out += np.log(1.0 + (n - df + 0.5) / (df + 0.5)) * tf * (TEXT_K1 + 1.0) / (tf + norm)
        return out

    def has(self, term: int) -> np.ndarray:
        return (self.matrix()[1] == term).any(1)

    def phrase(self, terms) -> np.ndarray:
        m = self.matrix()[1]
        w = m.shape[1] - len(terms) + 1
        hit = np.ones((len(m), max(w, 0)), dtype=bool)
        for j, t in enumerate(terms):
            hit &= m[:, j : j + w] == t
        return hit.any(1)

    def prefix(self, prefix: str, cap=8):
        """Ids of the live words that start with `prefix`, the most
        frequent first (alphabetical among equals), at most `cap`."""
        live = [(w, t) for w, t in sorted(self.words.items()) if w.startswith(prefix)]
        live = [(self.df(t), t) for w, t in live]
        live = [x for x in live if x[0] > 0]
        live.sort(key=lambda x: -x[0])
        return [t for _, t in live[:cap]]

    def expect(self, spec: dict, k: int):
        """(keys, scores) the index must answer `spec` with: documents that
        satisfy its masks with a score above 0, best first (lower row first
        among equals); a phrase is checked over the best 4k of those, as
        the index overfetches."""
        keys, _, _ = self.matrix()
        s = self.scores(spec["scored"])
        ok = s > 0
        for t in spec.get("required", ()):
            ok &= self.has(t)
        for t in spec.get("forbidden", ()):
            ok &= ~self.has(t)
        order = np.argsort(-s, kind="stable")
        order = order[ok[order]]
        if spec.get("phrase"):
            order = order[: 4 * k]
            order = order[self.phrase(spec["phrase"])[order]]
        return [keys[j] for j in order[: k + 1]], s[order[: k + 1]], dict(zip(keys, s)), ok


def _check_text_answer(label, oracle, spec, k, got_keys, got_scores=None) -> int:
    """One answer against the oracle: as many hits, every hit satisfies the
    query, the hits' oracle scores are the best k (so ties may swap), keys
    equal wherever a score stands apart from its neighbours, and the
    index's own scores within TEXT_TOL.  Returns the keys compared."""
    want_keys, want_s, score_of, ok = oracle.expect(spec, k)
    n = min(k, len(want_keys))
    if len(got_keys) != n:
        raise AssertionError(f"{label}: {len(got_keys)} hits, oracle {n}")
    keys = oracle.matrix()[0]
    row_of = {key: j for j, key in enumerate(keys)}
    for key in got_keys:
        if key not in row_of or not ok[row_of[key]]:
            raise AssertionError(f"{label}: {key!r} does not satisfy the query")
    got_s = np.array([score_of[key] for key in got_keys])
    if not np.allclose(got_s, want_s[:n], rtol=TEXT_TOL, atol=1e-9):
        raise AssertionError(f"{label}: scores of the hits {got_s} != oracle's best {want_s[:n]}")
    if got_scores is not None and not np.allclose(got_scores, want_s[:n], rtol=TEXT_TOL, atol=1e-6):
        raise AssertionError(f"{label}: index scores {got_scores} vs oracle {want_s[:n]}")
    compared = 0
    for j in range(n):
        left = j == 0 or want_s[j - 1] - want_s[j] > TEXT_TOL * want_s[j]
        right = j + 1 >= len(want_s) or want_s[j] - want_s[j + 1] > TEXT_TOL * want_s[j]
        if left and right:
            compared += 1
            if got_keys[j] != want_keys[j]:
                raise AssertionError(f"{label}: position {j}: {got_keys[j]!r} != {want_keys[j]!r}")
    return compared


def _zipf_rows(n, seed=11):
    """The JAX bench's text recipe: n documents of 24 words drawn from a
    zipf law over 20,000 words (word w is 'w<w>')."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, TEXT_VOCAB + 1)
    p /= p.sum()
    return rng.choice(TEXT_VOCAB, size=(n, TEXT_WORDS), p=p), rng, p


def _text_specs(oracle, tid) -> list:
    """The HTTP queries, each with what it means: plain, operators (+ is
    AND, a leading - forbids), a phrase (both words required, adjacent, in
    order) and prefixes (the live expansions, OR'd)."""
    specs = [
        ("w3 w17 w250", {"scored": [tid(3), tid(17), tid(250)]}),
        ("w0 w1", {"scored": [tid(0), tid(1)]}),
        ("w7 +w3", {"scored": [tid(7), tid(3)], "required": [tid(7), tid(3)]}),
        ("w7 w9 -w1 -w0", {"scored": [tid(7), tid(9)], "forbidden": [tid(1), tid(0)]}),
        ("w5 -w2", {"scored": [tid(5)], "required": [tid(5)], "forbidden": [tid(2)]}),
        ('"w1 w0"', {"scored": [tid(1), tid(0)], "required": [tid(1), tid(0)],
                     "phrase": [tid(1), tid(0)]}),
        ('"w2 w1"', {"scored": [tid(2), tid(1)], "required": [tid(2), tid(1)],
                     "phrase": [tid(2), tid(1)]}),
    ]
    for prefix in ("w12", "w300", "w7"):
        specs.append((prefix + "*", {"scored": oracle.prefix(prefix)}))
    return specs


async def phase_text_service(torch, device="cuda", n=N_TEXT_HTTP):
    """(a) A text index over HTTP on the card: create, add n documents,
    search, replace and remove, each answer held against the oracle."""
    import aiohttp

    from vector_store_tpu_torch import IndexId, new_index_factory, run

    rows, rng, _ = _zipf_rows(n)
    texts = [" ".join(f"w{t}" for t in row) for row in rows]
    oracle = TextOracle()
    tid = lambda w: _term_id(f"w{w}")  # noqa: E731
    server, engine = await run("127.0.0.1:0", new_index_factory(device=device))
    out = {}
    try:
        base = f"http://{server.addr}/api/v1/text-search"
        async with aiohttp.ClientSession() as http:
            async with http.put(base + "/articles") as r:
                if r.status != 200:
                    raise AssertionError(f"PUT text index: {r.status} {await r.text()}")
            handle = await engine.get_index(IndexId("articles"))
            idx = handle.backend.index
            if type(idx).__name__ != "BM25Index" or idx.device.type != device:
                raise AssertionError(f"PUT made {type(idx).__name__} on {idx.device}")
            sem = asyncio.Semaphore(IN_FLIGHT)

            async def add(key, text):
                async with sem:
                    async with http.post(base + "/articles/add", json={"id": key, "text": text}) as r:
                        if r.status != 200:
                            raise AssertionError(f"POST text add: {r.status} {await r.text()}")
                oracle.put(key, text)

            async def search(text, limit):
                async with http.post(base + "/articles/search",
                                     json={"text": text, "limit": limit}) as r:
                    if r.status != 200:
                        raise AssertionError(f"POST text search: {r.status} {await r.text()}")
                    return await r.json()

            t0 = time.perf_counter()
            await asyncio.gather(*(add(f"d{i}", t) for i, t in enumerate(texts)))
            out["http_docs_s"] = n / (time.perf_counter() - t0)
            async with http.get(base) as r:
                if await r.json() != ["articles"]:
                    raise AssertionError("the text index is not listed")
            async with http.get(f"http://{server.addr}/api/v1/indexes") as r:
                if await r.json() != []:
                    raise AssertionError("the text index shows in the ANN listing")

            async def check(stage):
                compared = 0
                specs = _text_specs(oracle, tid)
                answers = await asyncio.gather(*(search(text, 10) for text, _ in specs))
                for (text, spec), got in zip(specs, answers):
                    compared += _check_text_answer(f"text over HTTP, {stage}, {text!r}", oracle,
                                                   spec, 10, got)
                return len(specs), compared

            n_q, compared = await check("after ingest")
            # replace 100 documents by id (an add of a live id), remove 100 more
            new_rows = _zipf_rows(100, seed=12)[0]
            await asyncio.gather(*(
                add(f"d{i * 7}", " ".join(f"w{t}" for t in row)) for i, row in enumerate(new_rows)))
            gone = [f"d{i * 7 + 3}" for i in range(100)]
            await handle.remove_batch([(k,) for k in gone])
            for k in gone:
                oracle.remove(k)
            if await handle.count() != len(oracle.docs):
                raise AssertionError(
                    f"count {await handle.count()}, the oracle holds {len(oracle.docs)}")
            n_q2, compared2 = await check("after replace and remove")
            log(f"  text index over HTTP on {idx.device}: {n} documents added at "
                f"{out['http_docs_s']:.0f} docs/s ({IN_FLIGHT} in flight); {n_q} queries (plain, "
                f"+/-, phrase, prefix) equal the oracle's answers ({compared} keys at distinct "
                f"scores compared in order, the rest by score); after 100 replaced and 100 "
                f"removed again ({compared2} keys in order)")
    finally:
        await server.close()
        await engine.close()
    return out


def phase_text_index(torch, device="cuda", n=N_TEXT, n_cpu=N_TEXT_CPU):
    """(b) A BM25Index of n documents on the card, the JAX bench's recipe:
    the top-10 of 32 queries against the oracle, the same answers from a
    device="cpu" index on a prefix, and the layer's timings."""
    from vector_store_tpu_torch.text import bm25

    rows, rng, p = _zipf_rows(n)
    table = np.array([_term_id(f"w{w}") for w in range(TEXT_VOCAB)], dtype=np.int64)
    texts = [" ".join(f"w{t}" for t in row) for row in rows]
    q_rows = [rng.choice(TEXT_VOCAB, size=3, p=p) for _ in range(32)]
    q_batch = [" ".join(f"w{t}" for t in row) for row in q_rows]
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
    idx = bm25.BM25Index(initial_capacity=n, device=device)
    t0 = time.perf_counter()
    for text in texts:
        idx.add(text)
    out = {"docs_s": n / (time.perf_counter() - t0)}
    t0 = time.perf_counter()
    hits = idx.search(q_batch, 10)  # the first search uploads the rows
    first_s = time.perf_counter() - t0

    oracle = TextOracle()
    oracle.put_rows(range(n), rows, table)
    compared = 0
    for j, (row, got) in enumerate(zip(q_rows, hits)):
        spec = {"scored": [int(table[w]) for w in row]}
        compared += _check_text_answer(f"BM25Index query {j} {q_batch[j]!r}", oracle, spec, 10,
                                       [s for s, _ in got], np.array([v for _, v in got]))
    if compared < 32:
        raise AssertionError(f"only {compared} keys stood at distinct scores")

    # the same answers from a CPU index, on a prefix of the documents
    pair = {}
    for dev in dict.fromkeys((device, "cpu")):
        small = bm25.BM25Index(initial_capacity=n_cpu, device=dev)
        for text in texts[:n_cpu]:
            small.add(text)
        pair[dev] = small.search(q_batch, 10)
    same = 0
    for a, b in zip(pair[device], pair["cpu"]):
        sa, sb = np.array([v for _, v in a]), np.array([v for _, v in b])
        if len(a) != len(b) or not np.allclose(sa, sb, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"{device} and cpu indexes score differently: {a} vs {b}")
        same += [s for s, _ in a] == [s for s, _ in b]
    small_oracle = TextOracle()
    small_oracle.put_rows(range(n_cpu), rows[:n_cpu], table)
    for j, (row, got) in enumerate(zip(q_rows, pair["cpu"])):
        _check_text_answer(f"cpu BM25Index query {j}", small_oracle,
                           {"scored": [int(table[w]) for w in row]}, 10, [s for s, _ in got],
                           np.array([v for _, v in got]))

    log(f"  BM25Index on {idx.device}: {n} documents ({TEXT_WORDS} words, zipf over {TEXT_VOCAB}) "
        f"added at {out['docs_s']:.0f} docs/s (host); first search (upload of "
        f"{idx._dev_rows} x {bm25.MAX_DOC_TERMS} terms and counts, "
        f"{idx._dev_rows * bm25.MAX_DOC_TERMS * 8 / 1e6:.0f} MB) {first_s:.2f} s; top-10 of 32 "
        f"queries equal the oracle's ({compared} keys at distinct scores in order, all by score, "
        f"scores within {TEXT_TOL:g}); {n_cpu}-document prefix: {device} and cpu indexes agree "
        f"({same}/32 answers in the same order, all scores within 1e-5), cpu equals the oracle")
    if device != "cuda":
        return out

    # timings: the device pass alone and search() end to end, in turns
    with idx._lock:
        arrays = idx._device_arrays()
        parsed = [bm25.query_mod.parse(t, expander=idx) for t in q_batch]
        packed = [torch.from_numpy(a).to(idx.device) for a in idx._pack_queries(parsed)]
        avg = torch.tensor(max(idx._total_len / idx._size, 1.0), dtype=torch.float32,
                           device=idx.device)
    passes, e2e = [], []
    for _ in range(4):
        passes.append(_time_ms(torch, lambda: bm25._score_topk(*arrays, *packed, avg, 10), 3))
        t0 = time.perf_counter()
        for _ in range(3):
            idx.search(q_batch, 10)
        e2e.append(3 * len(q_batch) / (time.perf_counter() - t0))
    out["pass_ops"] = _count_kernels(torch, lambda: bm25._score_topk(*arrays, *packed, avg, 10))
    out["pass_ms"] = (float(np.median(passes)), min(passes), max(passes))
    out["search_qps"] = (float(np.median(e2e)), min(e2e), max(e2e))
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - mem0
    pm, qps = out["pass_ms"], out["search_qps"]
    bytes_ms = idx._dev_rows * (bm25.MAX_DOC_TERMS * 8 + 5) / HBM_BYTES_S * 1e3
    log(f"  device pass for 32 queries over {idx._dev_rows} rows: {pm[0]:.3f} ms "
        f"[{pm[1]:.3f}-{pm[2]:.3f}] ({32e3 / pm[0]:.0f} queries/s), {out['pass_ops']} device "
        f"operations, the rows read once would take {bytes_ms:.3f} ms; search() end to end "
        f"(parse, pass, readback, filter) {qps[0]:.0f} QPS [{qps[1]:.0f}-{qps[2]:.0f}] over 4 "
        f"turns; peak device memory of the phase {out['peak_bytes'] / 2**20:.0f} MiB")
    if out["peak_bytes"] > TEXT_MAX_BYTES:
        raise AssertionError(f"text search peaked at {out['peak_bytes']} bytes of device memory")
    del idx, arrays
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 11: the graph's snapshot


def phase_graph_snapshot(torch, idx, queries, device="cuda"):
    """Save a built graph, load it, and ask both the same 256 queries."""
    import tempfile

    from vector_store_tpu_torch.core import graph_cuda, persist

    q = queries[:256]
    _, want = idx.search(q, 10)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "graph.npz")
        t0 = time.perf_counter()
        persist.save(path, idx, keymap_blob={"rows": idx.frontier})
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded, blob = persist.load(path, device=device)
        _sync(torch, device)
        load_s = time.perf_counter() - t0
    if blob != {"rows": idx.frontier} or loaded.count() != idx.count() or loaded.cfg != idx.cfg:
        raise AssertionError(f"snapshot changed the index: {blob} {loaded.count()} {loaded.cfg}")
    for key in graph_cuda.LAUNCHES:
        graph_cuda.LAUNCHES[key] = 0
    _, got = loaded.search(q, 10)
    launches = graph_cuda.LAUNCHES["expand_score"]
    if not np.array_equal(got, want):
        raise AssertionError(
            f"the loaded graph answers differently on {int((got != want).any(1).sum())} of 256 queries")
    if device == "cuda" and launches == 0:
        raise AssertionError("the loaded graph's search did not launch B3")
    log(f"  graph snapshot ({idx.frontier} x {idx.cfg.dims} {idx.cfg.dtype}, degree "
        f"{idx.cfg.degree}, router {idx.cfg.route_k}): saved in {save_s:.2f} s, "
        f"{size / 2**20:.1f} MiB (npz, compressed), loaded in {load_s:.2f} s; 256 queries "
        f"return the same ids; B3 launches of that search: {launches}")
    return {"save_s": save_s, "load_s": load_s, "bytes": size, "launches": launches}


# --------------------------------------------------------------------------
# phase 12: the ingest pipeline


N_PIPELINE, N_OVERWRITE, N_TOMBSTONE, PIPELINE_TURNS = 250_000, 2000, 1000, 3


def _b1_on_index(torch, idx, queries, device, k=10):
    """B1 against its plain version on a served IvfIndex's own bank, routed
    as the index routes: (max |d err|, share of ids equal, positions
    compared).  On the CPU (a rehearsal) the wrapper is the plain version."""
    return _b1_on_state(torch, idx.state, queries, idx.probes, device, k)


def _b1_on_state(torch, st, queries, probes, device, k=10):
    """_b1_on_index on a bare IvfState (one shard's bank of a sharded index)."""
    from vector_store_tpu_torch.core import ivf_cuda as ic

    qf, cids, _ = ic.route(st, torch.as_tensor(queries, device=device), "cosine", probes)
    rid_masked, nsb = ic.scan_masks(st)
    d_k, r_k = ic.search_fused(st.vectors, st.scales, rid_masked, qf, cids, "cosine", k, nsb)
    d_p, r_p = ic.search_fused_plain(st.vectors, st.scales, rid_masked, qf, cids, "cosine", k + 1, nsb)
    _sync(torch, device)
    return _compare_topk(torch, d_k, r_k.long(), d_p, r_p.long(), k)


async def phase_pipeline(torch, device="cuda", n=N_PIPELINE, turns=PIPELINE_TURNS):
    """The JAX bench's config-3 pipeline: MemDb.preload of n x 768 rows ->
    MonitorIndexes -> monitor_items -> an int8 IVF index sized up front
    (reserve_rows), `turns` times over; recall@10 of the last; then a burst
    of overwrites and tombstones.  The rows are the bench corpus recipe
    (clustered), not the JAX bench's plain gaussian: on unclustered
    768-d rows recall@10 says nothing."""
    from vector_store_tpu_torch import IndexId, IndexParams, Limit
    from vector_store_tpu_torch.core import ivf_cuda
    from vector_store_tpu_torch.engine.ann_index import AnnIndexFactory
    from vector_store_tpu_torch.engine.engine import new_engine
    from vector_store_tpu_torch.ingest import MemDb, MonitorIndexes

    corpus = make_corpus(n, DIM, seed=SEED + 7)
    queries = make_queries(corpus, 256, seed=SEED + 7)
    rates = []
    for turn in range(turns):
        db = MemDb()
        db.add_table("vectors", ("id",), DIM)
        db.preload("vectors", [(i,) for i in range(n)], corpus)
        db.add_index("ks.stream", "vectors",
                     IndexParams(dimensions=DIM, space="cosine", dtype="int8"))
        engine = await new_engine(AnnIndexFactory(backend="ivf", reserve_rows=n, device=device))
        monitor = MonitorIndexes(db, engine, tick_s=0.05)
        t0 = time.perf_counter()
        monitor.spawn()
        try:
            handle = None
            deadline = t0 + 300
            while True:
                handle = handle or await engine.get_index(IndexId("ks.stream"))
                count = 0 if handle is None else await handle.count()
                if count == n:
                    break
                if time.perf_counter() > deadline:
                    raise AssertionError(f"pipeline stuck at {count} of {n} rows")
                await asyncio.sleep(0.02)
            _sync(torch, device)
            rates.append(n / (time.perf_counter() - t0))
            if turn < turns - 1:
                continue
            idx = handle.backend.index
            if type(idx).__name__ != "IvfIndex" or idx.dtype != "int8":
                raise AssertionError(f"the pipeline filled a {type(idx).__name__} {idx.dtype}")

            async def ann(vecs, limit=10):
                res = await asyncio.gather(*(handle.ann(v, Limit(limit)) for v in vecs))
                return [[k[0] for k in keys] for keys, _ in res]

            # B1 at this path's shape, held against its plain version on the
            # filled bank; then the counts go to 0 just before the searches
            # that are this phase's main path
            plain = _b1_on_index(torch, idx, queries, device)
            for key in ivf_cuda.LAUNCHES:
                ivf_cuda.LAUNCHES[key] = 0
            truth = _oracle(torch, corpus, corpus[:0], queries, 10, device)
            recall = _recall(await ann(queries), truth)
            # a burst: overwrites (the row of key i becomes a new vector) and tombstones
            rng = np.random.default_rng([SEED, 12])
            picks = rng.choice(n, N_OVERWRITE + N_TOMBSTONE, replace=False)
            over, dead = picks[:N_OVERWRITE], picks[N_OVERWRITE:]
            fresh = make_extra(corpus, N_OVERWRITE, seed=SEED + 8)
            old = corpus[over].copy()
            t1 = time.perf_counter()
            for key, vec in zip(over.tolist(), fresh):
                await db.insert_values("vectors", (key,), vec)
            for key in dead.tolist():
                await db.delete_values("vectors", (key,))
            while await handle.count() != n - N_TOMBSTONE:
                if time.perf_counter() > t1 + 120:
                    raise AssertionError(f"count {await handle.count()} after the burst")
                await asyncio.sleep(0.02)
            # the last overwrite may still be behind the count: wait for it
            while (await ann(fresh[-1:], 1))[0] != [int(over[-1])]:
                if time.perf_counter() > t1 + 120:
                    raise AssertionError("the last overwrite never became visible")
                await asyncio.sleep(0.02)
            burst_s = time.perf_counter() - t1
            at_new = await ann(fresh, 1)
            moved = float(np.mean([a == [k] for a, k in zip(at_new, over.tolist())]))
            at_old = await ann(old[:256], 1)  # before the burst each key stood first there
            stale = sum(k in a for a, k in zip(at_old, over[:256].tolist()))
            at_dead = await ann(corpus[dead[:256]], 10)
            back = sum(k in a for a, k in zip(at_dead, dead[:256].tolist()))
            dead_set = set(dead.tolist())
            any_dead = sum(k in dead_set for a in at_dead + await ann(queries) for k in a)
            launches = dict(ivf_cuda.LAUNCHES)
            # and once more on the bank the burst left (tombstones, moved rows)
            plain_after = _b1_on_index(torch, idx, queries, device)
        finally:
            await monitor.stop()
            await db.close_streams()
            await engine.close()
            if device == "cuda":
                torch.cuda.empty_cache()
    med = float(np.median(rates))
    log(f"  pipeline MemDb.preload -> MonitorIndexes -> monitor_items -> int8 IvfIndex "
        f"(reserve_rows {n}; {idx.n_clusters} clusters x bucket {idx.state.bucket}), {n} x {DIM} "
        f"rows: {med:.0f} vec/s [{min(rates):.0f}-{max(rates):.0f}] over {turns} turns (host "
        f"clock, index creation to the full count); recall@10 of 256 queries through the "
        f"handle {recall:.4f}")
    log(f"  burst of {N_OVERWRITE} overwrites and {N_TOMBSTONE} tombstones applied in "
        f"{burst_s:.2f} s: count {n - N_TOMBSTONE}; overwritten keys found first at their new "
        f"row {moved:.4f}, still answering at their old row {stale} of 256; tombstoned keys "
        f"returned {back + any_dead}; B1/B2 launches of the phase's searches {launches}")
    for label, (err, agree, n_sep) in (("the filled bank", plain), ("the bank after the burst", plain_after)):
        log(f"  B1 vs its plain version on {label} (256 queries, {idx.probes} probes, "
            f"k 10): max|d err| {err:.3e}, ids agree {agree:.4f} on {n_sep} separated")
        if err > TOL or agree < 1.0:
            raise AssertionError(f"B1 disagrees with its plain version on {label} of the "
                                 f"pipeline: err {err}, ids agree {agree}")
    if recall < MIN_RECALL:
        raise AssertionError(f"pipeline recall@10 {recall} < {MIN_RECALL}")
    if moved < 0.99 or stale or back or any_dead:
        raise AssertionError(f"the burst left a wrong state: moved {moved}, stale {stale}, "
                             f"tombstoned returned {back + any_dead}")
    if device == "cuda" and launches["search_fused"] == 0:
        raise AssertionError(f"the pipeline's searches did not launch B1: {launches}")
    return {"vec_s": (med, min(rates), max(rates)), "recall": recall, "launches": launches,
            "err": max(plain[0], plain_after[0])}


# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# phase 13: the sharded backends, as four logical shards on one card

N_SHARDS = 4
MIN_RECALL_TWO_STAGE_SHARDED = 0.85


def _median_range(vals) -> str:
    return f"{float(np.median(vals)):.0f} [{min(vals):.0f}-{max(vals):.0f}]"


def _zero(counter: dict) -> None:
    for key in counter:
        counter[key] = 0


async def phase_sharded_ivf(torch, data, single_recall, device="cuda", shards=N_SHARDS):
    """Kind "ivf" with n_devices=4 over HTTP on a mesh that names one device
    four times: the rows of phases 2-3 again, recall@10 against the same
    exact f32 oracle, B1 on every shard and against its plain version on
    one shard's bank, keys back from gids, the two-stage scan, a snapshot."""
    import tempfile

    import aiohttp

    from vector_store_tpu_torch import IndexId, new_index_factory, run
    from vector_store_tpu_torch.core import ivf_cuda
    from vector_store_tpu_torch.core.ivf import QCHUNK, derive_coarse
    from vector_store_tpu_torch.shard.sharded_ivf import ShardedIvfIndex

    corpus, extra, queries, truth = data
    n = len(corpus)
    mesh = [torch.device(device)] * shards
    server, engine = await run(
        "127.0.0.1:0", new_index_factory(device=mesh, n_devices=shards))
    out = {}
    try:
        base = f"http://{server.addr}/api/v1/indexes/{KS}/sharded"
        async with aiohttp.ClientSession() as http:
            await _put_index(http, base, {"dimensions": DIM, "space": "cosine", "dtype": "int8",
                                          "kind": "ivf"})
            handle = await engine.get_index(IndexId.from_parts(KS, "sharded"))
            idx = handle.backend.index
            if not isinstance(idx, ShardedIvfIndex) or idx.n_shards != shards:
                raise AssertionError(f"PUT made {type(idx).__name__}")
            # main path from here: the launches of this run only
            _zero(ivf_cuda.LAUNCHES)
            ingest_s = await _ingest(http, base, handle, corpus, extra)
            want = n + len(extra)
            fill = [b.n_live for b in idx._books]
            log(f"  sharded IVF over HTTP: {want} rows in {ingest_s:.2f} s "
                f"({want / ingest_s:.0f} vec/s through the handle); {shards} shards of "
                f"{idx.n_clusters} clusters x bucket {idx.bucket}, rows per shard {fill}")
            if max(fill) - min(fill) > 1 or sum(fill) != want:
                raise AssertionError(f"the deal left the shards unbalanced: {fill}")
            got = await _http_ann(http, base, queries[:N_HTTP], 10)
            out["recall_http"] = _recall(got, truth[:N_HTTP])
            own = await _http_ann(http, base, extra[:64], 1)
            back = sum(g[:1] == [n + j] for j, g in enumerate(own))
            big = await _http_ann(http, base, queries[:8], 50)
            if any(len(b) != 50 for b in big):
                raise AssertionError("limit=50 queries returned short lists")
            out["launches"] = dict(ivf_cuda.LAUNCHES)
            log(f"  HTTP ann limit=10 x {N_HTTP}: recall@10 {out['recall_http']:.4f} against the "
                f"exact f32 oracle (one card, phases 2-3: {single_recall:.4f}); {back}/64 rows "
                f"posted through /add come back first under their own key; limit=50 x 8 ok; "
                f"launches {out['launches']}")
            if out["recall_http"] < max(MIN_RECALL, single_recall - 0.05):
                raise AssertionError(f"sharded recall {out['recall_http']} vs {single_recall}")
            if back != 64:
                raise AssertionError(f"only {back}/64 gids decode to the keys that were upserted")

            if device == "cuda":
                # one search of 2,048 queries: every shard launches B1 once a chunk
                chunks = -(-len(queries) // QCHUNK)
                _zero(ivf_cuda.LAUNCHES)
                _, ids = idx.search(queries, 10)
                b1 = ivf_cuda.LAUNCHES["search_fused"]
                _zero(ivf_cuda.LAUNCHES)
                idx.search(queries[:QCHUNK], 50)
                b2 = ivf_cuda.LAUNCHES["pool_scan"]
                log(f"  one search of {len(queries)} queries launched B1 {b1} times = {shards} "
                    f"shards x {chunks} chunks; one of {QCHUNK} at k 50 launched B2 {b2} times")
                if b1 != shards * chunks or b2 != shards:
                    raise AssertionError(f"not every shard launched: B1 {b1}, B2 {b2}")
                out["launches"]["search_fused"] += b1
                out["launches"]["pool_scan"] += b2
            _, ids = idx.search(queries, 10)
            out["recall_batch"] = _recall([r.tolist() for r in ids], truth)
            # gids decode: a gid's shard and local rowid name the bank slot it was read from
            shard, rowid = idx.decode(int(ids[0, 0]))
            k_, p_ = idx._books[shard].loc[rowid]
            if int(idx.states[shard].rowid[k_, p_]) != rowid:
                raise AssertionError("a returned gid does not decode to its shard's row")

            # B1 against its plain version on one shard's bank, at this path's shape
            err, agree, n_sep = _b1_on_state(torch, idx.states[1], queries[:256], idx.probes, device)
            out["err"] = err
            log(f"  B1 vs plain on shard 1's bank ({idx.n_clusters} x {idx.bucket} int8, 256 "
                f"queries, p {idx.probes}, k 10): max|d err| {err:.3e}, ids agree {agree:.4f} on "
                f"{n_sep} separated")
            if err > TOL or agree < 1.0:
                raise AssertionError(f"B1 disagrees with plain on a shard's bank: {err}, {agree}")

            # the two-stage scan on the same banks
            idx.coarse = True  # nothing mutates the index while it is switched
            _zero(ivf_cuda.LAUNCHES)
            _, ids2 = idx.search(queries, 10)
            out["launches_two_stage"] = dict(ivf_cuda.LAUNCHES)
            out["recall_two_stage"] = _recall([r.tolist() for r in ids2], truth)
            log(f"  two-stage (coarse int4 + int8 rescore) on the sharded banks: recall@10 "
                f"{out['recall_two_stage']:.4f} vs single-stage {out['recall_batch']:.4f}; "
                f"launches {out['launches_two_stage']}")
            if out["recall_two_stage"] < max(MIN_RECALL_TWO_STAGE_SHARDED,
                                             out["recall_batch"] - 0.10):
                raise AssertionError(f"sharded two-stage recall {out['recall_two_stage']}")
            if device == "cuda" and out["launches_two_stage"] != {
                    "search_fused": 0, "pool_scan": shards * -(-len(queries) // QCHUNK)}:
                raise AssertionError(f"two-stage launches {out['launches_two_stage']}")
            # B2 against its plain version on one shard's packed bank, as
            # the two-stage scan calls it (the rounded query, this shard's route)
            st = idx.states[1]
            # (a rehearsal too small to have clustered has derived no bank yet)
            coarse = idx._coarse_banks[1] if idx._coarse_banks else derive_coarse(st.vectors)
            q2, cids2, _ = ivf_cuda.route(
                st, torch.as_tensor(queries[:256], device=device), "cosine", idx.probes, rounded=True)
            rid2, nsb2 = ivf_cuda.scan_masks(st)
            args = (coarse, st.scales, rid2, q2.float(), cids2, "cosine", True, nsb2)
            pool_k, pool_p = ivf_cuda.pool_scan_fused(*args), ivf_cuda.pool_scan_plain(*args)
            _sync(torch, device)
            if not torch.equal(torch.isinf(pool_k), torch.isinf(pool_p)):
                raise AssertionError("B2 INF pattern differs from plain on a shard's packed bank")
            out["err_b2"] = float((pool_k - pool_p)[torch.isfinite(pool_p)].abs().max())
            log(f"  B2 vs plain on shard 1's packed int4 bank (256 queries, p {idx.probes}, pool "
                f"{tuple(pool_p.shape)}): max|d err| {out['err_b2']:.3e}, INF where plain has INF")
            if out["err_b2"] > TOL:
                raise AssertionError(f"B2 disagrees with plain on a shard's bank: {out['err_b2']}")
            del pool_k, pool_p
            idx.coarse = False

            # snapshot: saved, loaded onto the same mesh, searched
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "sharded.npz")
                t = time.perf_counter()
                idx.save(path)
                save_s = time.perf_counter() - t
                size = os.path.getsize(path)
                t = time.perf_counter()
                back_idx = ShardedIvfIndex.load(path, mesh=mesh)
                _sync(torch, device)
                load_s = time.perf_counter() - t
                _, a = idx.search(queries, 10)
                _, b = back_idx.search(queries, 10)
                if not np.array_equal(a, b) or back_idx.count() != idx.count():
                    raise AssertionError("the loaded sharded index answers differently")
                try:
                    ShardedIvfIndex.load(path, mesh=mesh[:2])
                except ValueError as exc:
                    refused = str(exc)
                else:
                    raise AssertionError("a snapshot of 4 shards loaded onto 2")
                del back_idx
            log(f"  snapshot: save {save_s:.2f} s, load {load_s:.2f} s ({size / 2**30:.3f} GiB); "
                f"the loaded index returns the same ids; on a mesh of 2: {refused!r}")
    finally:
        await server.close()
        await engine.close()
    return out


def sharded_ivf_turns(torch, data, device="cuda", shards=N_SHARDS):
    """Ingest vec/s (one add of all rows into an index sized for them, so a
    single recluster) and batch QPS (2,048 queries in one call) of the
    4-shard index beside a 1-shard index of the same rows, in turns; then
    the merge's share of one chunk's device time."""
    from vector_store_tpu_torch import IndexParams
    from vector_store_tpu_torch.core import ivf_cuda as ic
    from vector_store_tpu_torch.shard.mesh import gid_merge
    from vector_store_tpu_torch.shard.sharded_ivf import ShardedIvfIndex

    corpus, _, queries, truth = data
    params = IndexParams(dimensions=DIM, space="cosine", dtype="int8")
    dev = torch.device(device)
    ingest = {1: [], shards: []}
    kept = {}
    for s in (shards, 1, 1, shards):
        kept.pop(s, None)
        torch.cuda.empty_cache()
        idx = ShardedIvfIndex(params, mesh=[dev] * s, initial_capacity=len(corpus))
        t = time.perf_counter()
        idx.add(corpus)
        torch.cuda.synchronize()
        ingest[s].append(len(corpus) / (time.perf_counter() - t))
        kept[s] = idx
    qps = {1: [], shards: []}
    recall = {}
    for idx in kept.values():
        idx.search(queries, 10)  # warm: the allocator has seen every shape
    for s in (shards, 1, 1, shards, shards, 1, 1, shards):
        idx = kept[s]
        t = time.perf_counter()
        _, ids = idx.search(queries, 10)
        qps[s].append(len(queries) / (time.perf_counter() - t))
        recall[s] = _recall([r.tolist() for r in ids], truth)
    for s in (shards, 1):
        log(f"  {s}-shard index on one card, {len(corpus)} rows ({kept[s].n_clusters} clusters x "
            f"bucket {kept[s].bucket} a shard): ingest {_median_range(ingest[s])} vec/s over "
            f"{len(ingest[s])} turns; search of {len(queries)} queries "
            f"{_median_range(qps[s])} QPS over {len(qps[s])} turns; recall@10 {recall[s]:.4f}")

    # the merge's share: one chunk of 256 queries, device time by events
    idx = kept[shards]
    masks = [ic.scan_masks(st) for st in idx.states]
    q = torch.as_tensor(queries[:256], device=dev)

    def scans():
        return [ic.search_clustered_fused(st, q, "cosine", 10, idx.probes, m)
                for st, m in zip(idx.states, masks)]

    parts = scans()
    t = _turns(torch, {"scan + merge": lambda: gid_merge(scans(), 10),
                       "merge": lambda: gid_merge(parts, 10)}, 20, cold=False)
    share = t["merge"][0] / t["scan + merge"][0]
    log(f"  one chunk of 256 queries on the {shards}-shard index: route + B1 on every shard + "
        f"merge {_fmt(t['scan + merge'])}, the merge alone {_fmt(t['merge'])}: {share:.3f} of it")
    return {"ingest": ingest, "qps": qps, "recall": recall, "merge_share": share,
            "merge_ms": t["merge"][0], "chunk_ms": t["scan + merge"][0]}


async def phase_sharded_graph(torch, n=N_GRAPH, device="cuda", n_remove=N_REMOVE,
                              shards=N_SHARDS):
    """Kind "ann" with n_devices=4 over HTTP: ingest, queries against the
    exact f32 oracle, B3's launches per shard, removes, a compaction whose
    gid remap the keymap follows."""
    import aiohttp

    from vector_store_tpu_torch import IndexId, new_index_factory, run
    from vector_store_tpu_torch.core import graph_cuda
    from vector_store_tpu_torch.shard.sharded_index import ShardedSlotIndex

    corpus = make_corpus(n, DIM)
    extra = make_extra(corpus, EXTRA_ROWS)
    queries = make_queries(corpus, N_HTTP)
    # the oracle's top 40, so that the top 10 of the rows left after the
    # removes can be read from it
    deep = _oracle(torch, corpus, extra, queries, 40, device)
    mesh = [torch.device(device)] * shards
    server, engine = await run(
        "127.0.0.1:0", new_index_factory(device=mesh, n_devices=shards))
    out = {}
    try:
        base = f"http://{server.addr}/api/v1/indexes/{KS}/shgraph"
        async with aiohttp.ClientSession() as http:
            await _put_index(http, base, {"dimensions": DIM, "space": "cosine", "capacity": n})
            handle = await engine.get_index(IndexId.from_parts(KS, "shgraph"))
            backend = handle.backend
            idx = backend.index
            if not isinstance(idx, ShardedSlotIndex) or idx.cfg.dtype != "bfloat16":
                raise AssertionError(f"PUT made {type(idx).__name__} {idx.cfg.dtype}")
            _zero(graph_cuda.LAUNCHES)
            ingest_s = await _ingest(http, base, handle, corpus, extra)
            want = n + len(extra)
            out["launches_ingest"] = graph_cuda.LAUNCHES["expand_score"]
            log(f"  sharded graph over HTTP: {want} rows in {ingest_s:.2f} s "
                f"({want / ingest_s:.0f} vec/s); {shards} shards of capacity {idx.capacity}, rows "
                f"{idx._sizes.tolist()}; B3 launches {out['launches_ingest']}")
            _zero(graph_cuda.LAUNCHES)
            got = await _http_ann(http, base, queries, 10)
            out["launches_query"] = graph_cuda.LAUNCHES["expand_score"]
            out["recall_http"] = _recall(got, deep[:, :10])
            _zero(graph_cuda.LAUNCHES)
            idx.search(queries[:256], 10)
            one = graph_cuda.LAUNCHES["expand_score"]
            log(f"  HTTP ann limit=10 x {len(queries)}: recall@10 {out['recall_http']:.4f} against "
                f"the exact f32 oracle (bf16 banks); B3 launches {out['launches_query']}; one "
                f"search of 256 queries launches B3 {one} times = {shards} shards x "
                f"{idx.cfg.search_iters} rounds")
            if device == "cuda" and (one != shards * idx.cfg.search_iters
                                     or out["launches_ingest"] == 0
                                     or out["launches_query"] % shards):
                raise AssertionError(f"B3 did not launch on every shard: {one}, {out}")
            out["launches_query"] += one

            # B3 against its plain version on one shard's graph, on the
            # middle expand round of a real search of that shard
            import types

            shard = types.SimpleNamespace(_lock=idx._lock, _state=idx.states[1],
                                          device=mesh[1], cfg=idx.cfg)
            _, (qf, sel, live), cfg = graph_rounds(torch, shard, queries[:256],
                                                   capture=idx.cfg.search_iters // 2)
            st = idx.states[1]
            i_k, e_k = graph_cuda.expand_score_fused(
                st.vectors, st.scales, st.neighbors, qf, sel, live, cfg.space)
            i_p, e_p = graph_cuda.expand_score_plain(
                st.vectors, st.scales, st.neighbors, qf, sel, live, cfg.space)
            _sync(torch, device)
            if not torch.equal(i_k, i_p) or not torch.equal(torch.isinf(e_k), torch.isinf(e_p)):
                raise AssertionError("B3 expand on a shard's graph: ids or INF pattern differ")
            out["err"] = float((e_k - e_p)[torch.isfinite(e_p)].abs().max())
            log(f"  B3 vs plain on shard 1's graph ({st.capacity} x {DIM} bf16, a captured round of "
                f"256 queries, beam {cfg.beam_width} x degree {cfg.degree}): max|d err| "
                f"{out['err']:.3e}, ids equal")
            if out["err"] > TOL:
                raise AssertionError(f"B3 disagrees with plain on a shard's graph: {out['err']}")

            removed = set(range(0, n, max(n // n_remove, 1))[:n_remove])
            left = [[k for k in row.tolist() if k not in removed][:10] for row in deep]
            sem = asyncio.Semaphore(IN_FLIGHT)

            async def remove(key):
                async with sem:
                    async with http.post(base + "/remove", json={"primary_key": [key]}) as r:
                        if r.status != 200:
                            raise AssertionError(f"POST remove: {r.status} {await r.text()}")

            await asyncio.gather(*(remove(k) for k in removed))
            await _wait_count(http, base, want - len(removed))
            for stage in ("removed", "compacted"):
                if stage == "compacted":
                    before = backend.keymap
                    t = time.perf_counter()
                    async with http.post(base + "/compact") as r:
                        count = (await r.json())["count"]
                    out["compact_s"] = time.perf_counter() - t
                    if count != want - len(removed) or int(idx._frontiers.sum()) != count:
                        raise AssertionError(f"compact: count {count}, rows {idx._frontiers}")
                    if backend.keymap is before:
                        raise AssertionError("the compaction did not swap the keymap")
                got = await _http_ann(http, base, queries, 10)
                back = sum(k in removed for g in got for k in g)
                out[f"recall_{stage}"] = _recall(got, left)
                log(f"  after {len(removed)} removes{' + compact' if stage == 'compacted' else ''}"
                    f": recall@10 {out[f'recall_{stage}']:.4f}; removed keys returned: {back}")
                if back:
                    raise AssertionError(f"{back} removed keys came back")
            log(f"  the compaction (rebuild of {count} rows, gid remap into a new keymap) took "
                f"{out['compact_s']:.2f} s")
            for key in ("recall_http", "recall_removed", "recall_compacted"):
                if out[key] < MIN_RECALL:
                    raise AssertionError(f"sharded graph {key} {out[key]} < {MIN_RECALL}")
    finally:
        await server.close()
        await engine.close()
    return out


def phase_sharded_text(torch, device="cuda", n=N_TEXT, shards=N_SHARDS):
    """A ShardedBM25Index of phase 10's 100,000 documents beside a BM25Index
    of the same: the top-10 of 32 queries equal to the single index and to
    the oracle wherever scores are distinct, scores within TEXT_TOL."""
    from vector_store_tpu_torch.text import bm25
    from vector_store_tpu_torch.text.sharded_bm25 import ShardedBM25Index

    rows, rng, p = _zipf_rows(n)
    table = np.array([_term_id(f"w{w}") for w in range(TEXT_VOCAB)], dtype=np.int64)
    texts = [" ".join(f"w{t}" for t in row) for row in rows]
    q_rows = [rng.choice(TEXT_VOCAB, size=3, p=p) for _ in range(32)]
    q_batch = [" ".join(f"w{t}" for t in row) for row in q_rows]
    single = bm25.BM25Index(initial_capacity=n, device=device)
    sharded = ShardedBM25Index(initial_capacity=n, mesh=[torch.device(device)] * shards)
    for text in texts:
        single.add(text)
        sharded.add(text)
    oracle = TextOracle()
    oracle.put_rows(range(n), rows, table)
    # the single index answers 11, so that position 9 has a right neighbour
    a, b = single.search(q_batch, 11), sharded.search(q_batch, 10)
    compared = same = 0
    for j, (row, one, many) in enumerate(zip(q_rows, a, b)):
        spec = {"scored": [int(table[w]) for w in row]}
        compared += _check_text_answer(f"ShardedBM25Index query {j}", oracle, spec, 10,
                                       [s for s, _ in many], np.array([v for _, v in many]))
        s1, s4 = np.array([v for _, v in one]), np.array([v for _, v in many])
        if len(one[:10]) != len(many) or not np.allclose(s1[:10], s4, rtol=TEXT_TOL, atol=1e-6):
            raise AssertionError(f"query {j}: sharded scores {s4} vs single {s1}")
        for pos, ((k1, v1), (k4, _)) in enumerate(zip(one, many)):
            apart = all(abs(v1 - s1[o]) > TEXT_TOL * v1 for o in (pos - 1, pos + 1)
                        if 0 <= o < len(s1))
            if apart and k1 != k4:
                raise AssertionError(f"query {j} position {pos}: {k4} vs single {k1}")
        same += [s for s, _ in one[:10]] == [s for s, _ in many]
    qps = {"single": [], "sharded": []}
    for name in ("sharded", "single", "single", "sharded"):
        idx = sharded if name == "sharded" else single
        t0 = time.perf_counter()
        for _ in range(3):
            idx.search(q_batch, 10)
        qps[name].append(3 * len(q_batch) / (time.perf_counter() - t0))
    log(f"  ShardedBM25Index, {shards} shards of {sharded._dev_rows} rows, {n} documents: top-10 "
        f"of 32 queries equal the oracle's ({compared} keys at distinct scores in order, scores "
        f"within {TEXT_TOL:g}) and the single index's ({same}/32 answers in the same order, the "
        f"rest differ among equal scores); search() {_median_range(qps['sharded'])} QPS sharded, "
        f"{_median_range(qps['single'])} single, 2 turns each")
    if compared < 32:
        raise AssertionError(f"only {compared} keys stood at distinct scores")
    return {"qps": qps}


def phase_host_recluster(torch, data, device="cuda"):
    """One recluster of a bank of real size through the host, with the
    threshold forced: the first clustering of all the rows (a staging bank
    permuted into the clustered one).  The same permutation also runs on the
    device from the same old bank, centroids and plan: the two new banks
    must be equal tensor for tensor, so the index answers the same."""
    from vector_store_tpu_torch import IndexParams
    from vector_store_tpu_torch.core import ivf

    corpus, _, queries, truth = data
    seen = {}
    real = ivf.permute_via_host

    def both(box, centroids, perm):
        old = box[0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        seen["device"] = ivf.permute_build(old, centroids, torch.as_tensor(perm, device=device))
        torch.cuda.synchronize()
        seen["device_s"] = time.perf_counter() - t
        seen["bytes"] = (old.vectors.numel() * old.vectors.element_size(),
                         seen["device"].vectors.numel() * old.vectors.element_size())
        del old
        t = time.perf_counter()
        new = real(box, centroids, perm)
        torch.cuda.synchronize()
        seen["host_s"] = time.perf_counter() - t
        return new

    idx = ivf.IvfIndex(IndexParams(dimensions=DIM, space="cosine", dtype="int8"),
                       initial_capacity=len(corpus), device=device)
    ivf.HOST_PERMUTE_BYTES, ivf.permute_via_host = 0, both
    try:
        idx.add(corpus)
    finally:
        ivf.HOST_PERMUTE_BYTES, ivf.permute_via_host = None, real
    if "host_s" not in seen:
        raise AssertionError("the forced recluster did not go through the host")
    for f in ivf._FIELDS:
        if not torch.equal(getattr(idx.state, f), getattr(seen["device"], f)):
            raise AssertionError(f"host and device permutes differ in {f}")
    _, via_host = idx.search(queries, 10)
    idx._state = seen.pop("device")
    _, on_device = idx.search(queries, 10)
    if not np.array_equal(via_host, on_device):
        raise AssertionError("the index answers differently after the host permute")
    rec = _recall([r.tolist() for r in via_host], truth)
    old_b, new_b = seen["bytes"]
    log(f"  recluster through the host, forced: {len(corpus)} rows, old bank {old_b / 2**30:.3f} "
        f"GiB -> new {new_b / 2**30:.3f} GiB ({idx.n_clusters} x {idx.state.bucket}): "
        f"{seen['host_s']:.2f} s (down, gather on the host, up) vs {seen['device_s']:.3f} s on the "
        f"device; the two banks are equal tensor for tensor and 2,048 queries get the same ids; "
        f"recall@10 {rec:.4f}")
    # the rule itself, on this card now
    free, total = torch.cuda.mem_get_info(torch.device(device))
    log(f"  the rule unforced: {free / 2**30:.1f} of {total / 2**30:.1f} GiB free, so this "
        f"recluster stays on the device: "
        f"{not ivf.permute_through_host(torch.device(device), old_b, new_b, new_b // DIM)}")
    if ivf.permute_through_host(torch.device(device), old_b, new_b, new_b // DIM):
        raise AssertionError("the rule sends a 1 GiB recluster through the host on an empty card")
    if ivf.permute_through_host(torch.device(device), old_b, total, total // DIM) is not True:
        raise AssertionError("the rule keeps a bank as large as the card on the device")
    return {"host_s": seen["host_s"], "device_s": seen["device_s"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from vector_store_tpu_torch.core import ivf_cuda
    from vector_store_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 oracle and route
    torch.backends.cudnn.allow_tf32 = False
    n = int(os.environ.get("VST_SMOKE_N", "1000000"))
    t_start = time.perf_counter()

    log("phase 0: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"  torch {torch.__version__}  CUDA {torch.version.cuda}  "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t = time.perf_counter()
    build.load_library()
    log(f"  kernels built and loaded in {time.perf_counter() - t:.1f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"    {line.strip()}")
    from vector_store_tpu_torch.api.routes import native_available

    log(f"  native JSON body parser (HTTP hot path) loaded: {native_available()}")

    log("phase 1: kernels vs plain PyTorch at serving shapes")
    report, timing = phase_kernels(torch)
    log("phase 1b: a bucket grown to 4,096 rows: B1 at k 10, B2 at k 50")
    big_bucket(torch)

    log(f"phase 2-3: service at N={n}")
    svc, geo = asyncio.run(phase_service(torch, n))
    torch.cuda.empty_cache()

    log("phase 4: graph kernel B3 vs plain PyTorch at serving shapes")
    b3_err, b3_timing = phase_graph_kernels(torch)

    log(f"phase 5: graph (kind ann) service at N={N_GRAPH}")
    gsvc = asyncio.run(phase_graph_service(torch))
    torch.cuda.empty_cache()

    log(f"phase 6: graph at the recorded geometry, N={N_GRAPH}")
    _, graph_idx, graph_queries = graph_geometry(torch)
    log("phase 11: a snapshot of that graph, saved, loaded and searched")
    snap = phase_graph_snapshot(torch, graph_idx, graph_queries)
    del graph_idx
    torch.cuda.empty_cache()

    log("phase 7: B1's score modes vs plain PyTorch, and their recall at the bench geometry")
    modes = phase_modes(torch)
    rates = bench_rates(torch, geo)
    mode_recall, mode_launches = modes_recall(torch, geo)
    log(f"  f32 recall@10 at the same geometry: {svc['bench_geometry']['recall_p2']:.4f}; stub "
        f"(B1's copy floor) {modes['stub']['ms']:.4f} ms = {modes['stub']['gbs']:.1f} GB/s of "
        f"bytes moved once vs f32 {timing['search_fused'][0]:.4f} ms = "
        f"{timing['search_fused'][2]:.1f} GB/s")

    log("phase 8: the two-stage scan and a snapshot round trip on the bench-geometry index")
    phase_two_stage(torch, geo)
    del geo
    torch.cuda.empty_cache()

    log("phase 9: copy-rate probe B4 vs plain PyTorch, and the roofline")
    b4 = phase_copy_probe(torch)
    roof = {sc: next(r["gbs"] for r in b4["rows"] if r["B"] == 128 and r["score"] == sc)
            for sc in (True, False)}
    synth = {"search_fused": timing["search_fused"][2], "pool_scan": timing["pool_scan"]["int8"][2]}
    for name, label in (("search_fused", "B1"), ("pool_scan", "B2")):
        gbs = rates[name][1]
        log(f"  {label} on the bench-geometry index moves the bytes it must move once at "
            f"{gbs:.1f} GB/s = {gbs / roof[False]:.3f} of B4's copy rate at B=128 "
            f"({roof[False]:.1f} GB/s; its score-on rate {roof[True]:.1f} GB/s is one warp per "
            f"row on CUDA cores, not a ceiling for tensor-core scoring); phase 1's synthetic "
            f"bank {synth[name]:.1f} GB/s = {synth[name] / roof[False]:.3f}")
        if max(gbs, synth[name]) > roof[False]:
            raise AssertionError(f"{label} reads faster than the copy rate: a rate is miscounted")

    log(f"phase 10: text search over HTTP ({N_TEXT_HTTP} documents) and a BM25Index of "
        f"{N_TEXT} documents")
    asyncio.run(phase_text_service(torch))
    phase_text_index(torch)

    log(f"phase 12: the ingest pipeline, {N_PIPELINE} x {DIM} rows through the monitors")
    pipe = asyncio.run(phase_pipeline(torch))
    torch.cuda.empty_cache()

    log(f"phase 13: the sharded backends, {N_SHARDS} logical shards on this one card (a mesh "
        f"that names cuda:0 {N_SHARDS} times: what is checked is the sharded code, and nothing "
        f"here says how it scales over cards)")
    data = svc.pop("data")
    sh_ivf = asyncio.run(phase_sharded_ivf(torch, data, svc["recall_http"]))
    torch.cuda.empty_cache()
    sharded_ivf_turns(torch, data)
    torch.cuda.empty_cache()
    phase_host_recluster(torch, data)
    del data
    torch.cuda.empty_cache()
    sh_graph = asyncio.run(phase_sharded_graph(torch))
    torch.cuda.empty_cache()
    phase_sharded_text(torch)
    torch.cuda.empty_cache()

    # library_ms: no single PyTorch call computes B1 (gather the probed
    # buckets, score, mask, top-k), B2 or B3 (each a gather before the
    # product) or B4 (a product, a min per block and a sum per group)
    no_library = "no single PyTorch call: a gather (B1-B3) or a min and sum (B4) comes first"
    src = "vector_store_tpu_torch/csrc/"
    kernels = [
        {
            # times: phase 1's shapes, int8, cosine, k 10
            "name": "ivf_search_fused",
            "route": "cuda",
            "source": src + "ivf_scan.cu",
            "replaces": "vector_store_tpu/core/ivf_pallas.py:128",
            "launches": svc["launches"]["search_fused"],
            "launches_pipeline": pipe["launches"]["search_fused"],
            "launches_sharded": sh_ivf["launches"]["search_fused"],
            "max_abs_err_sharded": sh_ivf["err"],
            "max_abs_err_pipeline": pipe["err"],
            "max_abs_err": report["search_fused"]["err"],
            "ms": timing["search_fused"][0],
            "plain_ms": timing["search_fused"][1],
            "bound_ms": timing["search_fused"][3],
            "bound_by": timing["search_fused"][4],
            "library_ms": None,
        },
    ]
    for mode in MODES:
        kernels.append({
            "name": f"ivf_search_fused[{mode}]",
            "route": "cuda",
            "source": src + "ivf_scan.cu",
            "replaces": "vector_store_tpu/core/ivf_pallas.py:128",
            "launches": mode_launches[mode],
            "max_abs_err": modes[mode]["err"],
            "ms": modes[mode]["ms"],
            "plain_ms": modes[mode]["plain_ms"],
            "bound_ms": modes[mode]["bound_ms"],
            "bound_by": modes[mode]["bound_by"],
            "library_ms": None,
        })
    b2 = timing["pool_scan"]["int8"]
    b2_bench = rates["b2 bench index Q=256 p=16"]["int8"]
    b3 = {shape: b3_timing[("bfloat16", shape)]["expand"] for shape in GRAPH_SHAPES}
    kernels += [
        {
            "name": "ivf_pool_scan",
            "route": "cuda",
            "source": src + "ivf_scan.cu",
            "replaces": "vector_store_tpu/core/ivf_pallas.py:252",
            "launches": svc["launches"]["pool_scan"],
            "launches_sharded": sh_ivf["launches"]["pool_scan"]
            + sh_ivf["launches_two_stage"]["pool_scan"],
            "max_abs_err_sharded": sh_ivf["err_b2"],
            "max_abs_err": report["pool_scan"]["err"],
            # times: phase 1's shapes, int8, cosine, cold L2 (median of turns)
            "ms": b2[0],
            "plain_ms": b2[1],
            "bound_ms": b2[3],
            "bound_by": b2[4],
            "library_ms": None,
            "ms_bench_index": b2_bench[0],
            "bound_ms_bench_index": b2_bench[3],
            "ms_d4096": timing["pool_scan_wide"]["int8"][0],
            "bound_ms_d4096": timing["pool_scan_wide"]["int8"][3],
        },
        {
            # B3 through its expand entry (the main path's); times: bf16 bank
            # (the route's default dtype), cold L2, median of turns, at the
            # search shape and (the *_insert keys) the insert shape
            "name": "graph_expand_score",
            "route": "cuda",
            "source": src + "graph_gather.cu",
            "replaces": "vector_store_tpu/core/graph_pallas.py:89",
            "launches": gsvc["launches_ingest"] + gsvc["launches_query"],
            "launches_ingest": gsvc["launches_ingest"],
            "launches_query": gsvc["launches_query"],
            "launches_snapshot_search": snap["launches"],
            "launches_sharded": sh_graph["launches_ingest"] + sh_graph["launches_query"],
            "max_abs_err_sharded": sh_graph["err"],
            "max_abs_err": b3_err,
            "ms": b3["search"][0],
            "plain_ms": b3["search"][1],
            "bound_ms": b3["search"][2],
            "bound_by": b3["search"][3],
            "library_ms": None,
            "ms_insert": b3["insert"][0],
            "plain_ms_insert": b3["insert"][1],
            "bound_ms_insert": b3["insert"][2],
        },
        {
            # times: B=128, score on, over the >= 1 GiB bank
            "name": "copy_probe_stream",
            "route": "cuda",
            "source": src + "copy_probe.cu",
            "replaces": "scripts/probe_dma.py:30",
            "launches": b4["launches"],
            "max_abs_err": b4["err"]["abs"],
            "ms": b4["ms"],
            "plain_ms": b4["plain_ms"],
            "bound_ms": b4["bound_ms"],
            "bound_by": b4["bound_by"],
            "library_ms": None,
        },
    ]
    for kern in kernels:
        kern["library_note"] = no_library
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
