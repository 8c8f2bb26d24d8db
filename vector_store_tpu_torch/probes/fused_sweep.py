"""Sweep B1 on the card: QPS and recall@10 of the fused probe-scan.

    python -m vector_store_tpu_torch.probes.fused_sweep [N] [probes ...]
        [--rpb N] [--score f32|qi8|bf16|stub] [--q N] [--no-oracle]
        [--live-prefix 0|1]

Port of scripts/probe_fused_sweep.py at its headline shape (1024 queries
of the bench corpus, k=10, an int8 1M x 768 cosine index; N and the probe
counts from the command line, default 1,000,000 and 4).  `--rpb` sets the
rows-per-bucket geometry (default 170); `--score` picks B1's score mode;
`--live-prefix` pins one of the two scan widths (the live prefix or the
full padded bucket; both by default).  The TPU script's `--geo qg,nbuf`
was Mosaic geometry and has no counterpart.  Each point is timed with CUDA
events (best of 3 blocks of 8 calls over 8 rotations of the queries) and
printed as QPS, GB/s of padded-width bucket bytes (the TPU script's figure)
and GB/s of the rows actually read (live rows of the probed buckets).
"""

from __future__ import annotations

import argparse

import numpy as np

from . import DIM

K = 10


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("probes", nargs="*", type=int)
    ap.add_argument("--rpb", type=int, default=170)
    ap.add_argument("--score", choices=("f32", "qi8", "bf16", "stub"), default="f32")
    ap.add_argument("--q", type=int, default=1024, help="queries per call")
    ap.add_argument("--no-oracle", action="store_true", help="skip the exact recall oracle")
    ap.add_argument("--live-prefix", type=int, choices=(0, 1), default=None)
    args = ap.parse_args(argv)
    args.probes = args.probes or [4]
    return args


def main(argv=None) -> int:
    from . import card_line, load_or_build, require_cuda, time_ms
    from .data import recall_of
    from ..core import ivf_cuda as ic

    args = parse(argv)
    torch = require_cuda()
    print(f"# {card_line()}; torch {torch.__version__}", flush=True)
    idx, _, queries = load_or_build(args.n, args.rpb)
    queries = queries[: args.q]
    Q = len(queries)
    if args.no_oracle:
        exact = np.full((Q, K), -1, np.int64)  # recall prints ~0; timing only
    else:
        _, exact = idx.exact_search(queries, K)
    st = idx.state
    B = st.bucket
    qdev = [torch.as_tensor(np.roll(queries, r, axis=0), device="cuda") for r in range(8)]
    rid_masked, nsb = ic.scan_masks(st)
    full = ic.live_prefix_blocks(torch.ones_like(st.valid))  # padded width
    live_rows = st.valid.sum(dim=1)
    lp_modes = (False, True) if args.live_prefix is None else (bool(args.live_prefix),)
    for p in args.probes:
        _, cids, pp = ic.route(st, qdev[0], "cosine", p)
        rows_read = int(live_rows[cids.long()].sum())
        base_r = None
        for lp in lp_modes:
            masks = (rid_masked, nsb if lp else full)

            def call(r, masks=masks):
                return ic.search_clustered_fused(
                    st, qdev[r % 8], "cosine", K, p, masks, score=args.score
                )

            _, ids = call(0)
            rec = recall_of(ids.cpu().numpy(), exact)
            if base_r is None:
                base_r = rec
            elif abs(rec - base_r) > 0.005:
                print(f"#  p={p} lp={int(lp)}: RECALL DRIFT {rec:.3f} vs {base_r:.3f}")
            ms = time_ms(torch, call)
            s = ms * 1e-3
            print(f"#  p={p} lp={int(lp)} score={args.score}: qps={Q / s:.0f} "
                  f"padded={Q * pp * B * DIM / s / 1e9:.1f}GB/s "
                  f"rows-read={rows_read * DIM / s / 1e9:.1f}GB/s ({ms:.3f} ms/call)",
                  flush=True)
        print(f"# p={p} recall@10={base_r:.3f} (score={args.score})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
