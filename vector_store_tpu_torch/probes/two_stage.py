"""The two-stage IVF scan (int4 coarse + int8 rescore) on the card.

    python -m vector_store_tpu_torch.probes.two_stage [N] [--rpb N]
        [--cluster-min N]

Port of scripts/probe_two_stage.py at its headline shape (1024 queries,
k=10, an int8 N x 768 cosine index, default N 1,000,000 and rows per bucket
170).  It times `derive_coarse`, then for probes in 2, 3, 4, 6, 8 and cand
in 48, 80, 128: recall@10 of `search_two_stage` (B2 over the packed bank,
exact top-cand, int8 rescore), its QPS, the QPS of the coarse stage alone
(route + packed B2 + top-cand) with its GB/s of packed bucket bytes, and
the rescore's share.  Beside each probe count it prints the single-stage
B1 scan at the same probes.  Times are CUDA events (best of 3 blocks of 8
calls over 8 rotations of the queries).
"""

from __future__ import annotations

import argparse

import numpy as np

from . import DIM

K = 10
Q = 1024
SWEEP_PROBES = (2, 3, 4, 6, 8)
SWEEP_CAND = (48, 80, 128)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("--rpb", type=int, default=170)
    ap.add_argument("--cluster-min", type=int, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from . import card_line, load_or_build, require_cuda, time_ms
    from .data import recall_of
    from ..core import ivf_cuda as ic
    from ..core.ivf import derive_coarse, search_two_stage
    from ..core.topk import topk_ascending

    args = parse(argv)
    torch = require_cuda()
    print(f"# {card_line()}; torch {torch.__version__}", flush=True)
    idx, _, queries = load_or_build(args.n, args.rpb, cluster_min=args.cluster_min)
    queries = queries[:Q]
    _, exact = idx.exact_search(queries, K)
    st = idx.state
    B = st.bucket
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    coarse = derive_coarse(st.vectors)
    end.record()
    torch.cuda.synchronize()
    print(f"# coarse derive: {start.elapsed_time(end) / 1e3:.3f}s "
          f"({coarse.numel() >> 20}MB)", flush=True)
    qdev = [torch.as_tensor(np.roll(queries, r, axis=0), device="cuda") for r in range(8)]
    masks = ic.scan_masks(st)
    rid_masked, nsb = masks

    def coarse_only(qs, probes, cand):
        q, cids, _ = ic.route(st, qs, "cosine", probes, rounded=True)
        pool = ic.pool_scan_fused(coarse, st.scales, rid_masked, q.float(), cids, "cosine",
                                  True, nsb)
        return topk_ascending(pool, cand)[0]

    for probes in SWEEP_PROBES:
        _, ids = ic.search_clustered_fused(st, qdev[0], "cosine", K, probes, masks)
        ms = time_ms(torch, lambda r: ic.search_clustered_fused(
            st, qdev[r % 8], "cosine", K, probes, masks))
        print(f"# p={probes} single-stage B1: recall@10={recall_of(ids.cpu().numpy(), exact):.3f} "
              f"qps={Q / (ms * 1e-3):.0f}", flush=True)
        for cand in SWEEP_CAND:
            _, ids = search_two_stage(st, coarse, qdev[0], "cosine", K, probes, cand, masks=masks)
            rec = recall_of(ids.cpu().numpy(), exact)
            t_full = time_ms(torch, lambda r: search_two_stage(
                st, coarse, qdev[r % 8], "cosine", K, probes, cand, masks=masks))
            t_coarse = time_ms(torch, lambda r: coarse_only(qdev[r % 8], probes, cand))
            gbs = Q * probes * B * (DIM // 2) / (t_coarse * 1e-3) / 1e9
            print(f"#  p={probes} cand={cand}: recall@10={rec:.3f} qps={Q / (t_full * 1e-3):.0f} "
                  f"coarse-only={Q / (t_coarse * 1e-3):.0f} (packed={gbs:.1f}GB/s, rescore "
                  f"{t_full - t_coarse:.3f}ms/{Q}q)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
