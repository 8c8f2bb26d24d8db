"""Milliseconds of one graph insert block in the set-up's load: the span
`vst_graph_insert_block_seconds` (core/index.py, one block's upload and
beam-search insert), its sum over its count.  Read at the window's start,
when it holds the whole load."""


def read(r):
    before = r.window[0]
    blocks = before.get("vst_graph_insert_block_seconds_count")
    if not blocks:
        return None
    return 1e3 * before["vst_graph_insert_block_seconds_sum"] / blocks
