"""The engine's own seconds per million rows of the set-up's load: the
span `vst_engine_apply_upserts_seconds` (engine/ann_index.py, one message's
run in the executor: key checks, the rows stacked, the key bindings) less
the index's add inside it (`vst_index_add_seconds`).  Read at the window's
start, when both hold the whole load."""


def read(r):
    before = r.window[0]
    apply_s = before.get("vst_engine_apply_upserts_seconds_sum")
    add_s = before.get("vst_index_add_seconds_sum")
    if apply_s is None or add_s is None or r.load_rows <= 0:
        return None
    return (apply_s - add_s) / (r.load_rows / 1e6)
