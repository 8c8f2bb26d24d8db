"""Times B1 and B2 at phase 1's shapes, B2 at D=4,096 and B3's expand
round with the package it is run from, on the card, and prints one JSON
line.

    python3 -m vector_store_tpu_torch.probes.tree_turns --label new

To compare two checkouts of the repo (a commit and its parent, say), copy
this file into the other's vector_store_tpu_torch/probes/ and run it from
each checkout's root in turns, a b b a, on the same card.  It calls only
entry points that both designs have: search_fused, pool_scan_fused, and
gather_score_fused composed with the adjacency gather, as the expand round
was written before its fused entry (core/search.py's steps 2-3); and
expand_score_fused where the package has it.

The inputs are chip_smoke's, made on the card from the same seeds: B1
(f32 and qi8 modes, k 10) and B2 on phase 1's int8 bank and B2 on its
packed and bf16 banks (phase_kernels), B2 on the same serving shape at
D=4,096 (b2_wide_timing), B3 on phase 4's
262,144 x 768 bank at its search and insert shapes (bf16, the graph
route's default).  Every call is timed by CUDA events, L2 evicted before
it, the stream first held on the device for ~1 ms: longer than the host
takes to enqueue even the 13 operations of the unfused round, so each time
is the device's and none of it the host's.
"""

from __future__ import annotations

import argparse
import json

import torch

from . import card_line, require_cuda

SEED = 42
WAIT_CYCLES = 2_000_000  # ~1 ms of device time before each timed call


def time_ms(fn, reps: int) -> float:
    """Mean device ms per call of fn, L2 evicted before each."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.fill_(1.0)
        torch.cuda._sleep(WAIT_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def _normal_rows(gen, n, d):
    from ..core.distance import normalize

    return normalize(torch.randn((n, d), generator=gen, device="cuda"))


def scan_case(gen, Q, p, B, D, K):
    """chip_smoke's _scan_case: (rowid, nsb, queries, cids) of a K-bucket
    bank with a tenth of the rows tombstoned, every 8th bucket with a short
    live prefix."""
    from ..core import ivf_cuda as ic
    from ..core.topk import SENTINEL

    rowid = torch.arange(K * B, dtype=torch.int32, device="cuda").reshape(K, B)
    dead = torch.rand((K, B), generator=gen, device="cuda") < 0.1
    prefix = torch.randint(0, B, (K,), generator=gen, device="cuda")
    short = (torch.arange(K, device="cuda") % 8 == 0)[:, None] & (
        torch.arange(B, device="cuda")[None, :] >= prefix[:, None]
    )
    rid = torch.where(dead | short, SENTINEL, rowid)
    nsb = ic.live_prefix_blocks(rid != SENTINEL)
    q = _normal_rows(gen, Q, D)
    cids = torch.argsort(torch.rand((Q, K), generator=gen, device="cuda"), dim=1)[:, :p]
    return rid, nsb, q, cids.to(torch.int32).contiguous()


def banks(gen, K, B, D, dtypes):
    """chip_smoke's _bank for each dtype in turn, and for int8 also its
    packed int4 derivative: (name, bank, scales, packed)."""
    from ..core.quantize import pack_int4_from_int8, quantize_rows

    for dt in dtypes:
        rows = _normal_rows(gen, K * B, D)
        if dt == "int8":
            codes, scales = quantize_rows(rows)
            del rows
            vec, scl = codes.reshape(K, B, D), scales.reshape(K, B)
            yield dt, vec, scl, False
            yield "int4-packed", pack_int4_from_int8(vec), scl, True
        else:
            ones = torch.ones((K, B), device="cuda")
            yield dt, rows.to(getattr(torch, dt)).reshape(K, B, D), ones, False
        torch.cuda.empty_cache()


def b3_cases(C=262_144, D=768):
    """chip_smoke's phase 4 inputs (bf16 bank): {shape: (vec, scl, q,
    neighbors, sel_ids, sel_live)}."""
    from ..core.topk import SENTINEL

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = _normal_rows(gen, C, D)
    out = {}
    for name, (Q, B, R) in {"search": (256, 4, 32), "insert": (1024, 16, 32)}.items():
        q = _normal_rows(gen, Q, D)
        cand = torch.randint(0, C, (Q, B * R), generator=gen, device="cuda", dtype=torch.int32)
        nbrs = torch.randint(0, C, (C, R), generator=gen, device="cuda", dtype=torch.int32)
        nbrs[::7, R // 2 :] = SENTINEL
        sel = torch.randint(0, C, (Q, B), generator=gen, device="cuda", dtype=torch.int32)
        sel[:, 1] = sel[:, 0]
        live = torch.rand((Q, B), generator=gen, device="cuda") >= 0.1
        del cand  # drawn only to keep chip_smoke's sequence of draws
        out[name] = (q, nbrs, sel, live)
    vec = rows.to(torch.bfloat16)
    scl = torch.ones((C,), device="cuda")
    return {name: (vec, scl) + case for name, case in out.items()}


def unfused_round(vec, scl, q, nbrs, sel, live, space="cosine"):
    """Steps 2-3 of the expand round before its fused entry: the adjacency
    gather, masks and clamps in torch around the ids-given kernel."""
    from ..core import graph_cuda as gc
    from ..core.topk import INF, SENTINEL

    Q, B = sel.shape
    C, R = nbrs.shape
    cand = nbrs[sel.clamp(0, C - 1).long()]
    cand = cand.masked_fill(~live[..., None], SENTINEL).reshape(Q, B * R)
    is_sent = cand >= C
    dist = gc.gather_score_fused(vec, scl, q, cand.clamp(0, C - 1), space)
    return cand.masked_fill(is_sent, SENTINEL), dist.masked_fill(is_sent, INF)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    require_cuda()
    from ..core import graph_cuda as gc
    from ..core import ivf_cuda as ic
    from ..kernels.build import load_library

    load_library()
    out = {"label": args.label, "card": card_line(), "b1_ms": {}, "b2_ms": {},
           "b2_d4096_ms": {}, "b3_ms": {}}
    Q, p, B, K = 256, 16, 640, 512
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rid, nsb, q, cids = scan_case(gen, Q, p, B, 768, K)
    for name, vec, scl, packed in banks(gen, K, B, 768, ("int8", "bfloat16")):
        if name == "int8":
            for mode in ("f32", "qi8"):
                out["b1_ms"][mode] = time_ms(lambda: ic.search_fused(
                    vec, scl, rid, q, cids, "cosine", 10, nsb, mode), 5 * args.reps)
        out["b2_ms"][name] = time_ms(lambda: ic.pool_scan_fused(
            vec, scl, rid, q, cids, "cosine", packed, nsb), 5 * args.reps)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rid, nsb, q, cids = scan_case(gen, Q, p, B, 4096, K)
    for name, vec, scl, packed in banks(gen, K, B, 4096, ("int8", "bfloat16", "float32")):
        out["b2_d4096_ms"][name] = time_ms(lambda: ic.pool_scan_fused(
            vec, scl, rid, q, cids, "cosine", packed, nsb), args.reps)
        del vec
    for name, (vec, scl, q, nbrs, sel, live) in b3_cases().items():
        times = out["b3_ms"][name] = {}
        times["unfused_round"] = time_ms(
            lambda: unfused_round(vec, scl, q, nbrs, sel, live), 2 * args.reps
        )
        if hasattr(gc, "expand_score_fused"):
            times["expand"] = time_ms(
                lambda: gc.expand_score_fused(vec, scl, nbrs, q, sel, live, "cosine"), 2 * args.reps
            )
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
