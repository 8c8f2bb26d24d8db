"""Seconds the text index's add path took per million passages of the
set-up's load: the program's span `vst_text_add_seconds`
(engine/text_index.py, around `BM25Index.add_batch`: the batch's analysis,
its rows and bookkeeping, one growth), summed over the load's messages.
Read at the window's start, when it holds the whole load."""


def read(r):
    spent = r.window[0].get("vst_text_add_seconds_sum")
    if spent is None or r.load_rows <= 0:
        return None
    return spent / (r.load_rows / 1e6)
