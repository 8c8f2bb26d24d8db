"""The text engine's own seconds per million passages of the set-up's load:
the span `vst_text_apply_adds_seconds` (engine/text_index.py, one AddBatch
message's run in the executor: key checks, the add, the key bindings and
the removal of replaced slots) less the add inside it
(`vst_text_add_seconds`).  Read at the window's start, when both hold the
whole load."""


def read(r):
    before = r.window[0]
    apply_s = before.get("vst_text_apply_adds_seconds_sum")
    add_s = before.get("vst_text_add_seconds_sum")
    if apply_s is None or add_s is None or r.load_rows <= 0:
        return None
    return (apply_s - add_s) / (r.load_rows / 1e6)
