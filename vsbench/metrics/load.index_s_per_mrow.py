"""Seconds the index's add path took per million rows of the set-up's load:
the program's span `vst_index_add_seconds` (engine/ann_index.py, around
`self.index.add`: the graph's insert blocks, router rebuilds and growth, or
the IVF's placement, reclusters and bucket growth), summed over the load's
messages.  Read at the window's start, when it holds the whole load."""


def read(r):
    spent = r.window[0].get("vst_index_add_seconds_sum")
    if spent is None or r.load_rows <= 0:
        return None
    return spent / (r.load_rows / 1e6)
