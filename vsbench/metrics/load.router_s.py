"""Seconds the graph's router rebuilds took in the set-up's load: the span
`vst_graph_router_rebuild_seconds` (core/index.py, each k-means of the
centroid router as the frontier doubles past its threshold, and at the end
of an add); 0 where the graph's insert blocks ran and no rebuild did.  Read
at the window's start, when it holds the whole load."""


def read(r):
    before = r.window[0]
    if "vst_graph_insert_block_seconds_count" not in before:
        return None
    return before.get("vst_graph_router_rebuild_seconds_sum", 0.0)
