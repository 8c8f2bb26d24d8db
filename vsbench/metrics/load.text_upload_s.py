"""Seconds the text index's full uploads of its rows to the device took:
the span `vst_text_upload_seconds` (text/bm25.py, `_device_arrays` at the
first query after the load, the whole power-of-two row bucket at once).
Read at the window's start, after the warm-up's queries made it."""


def read(r):
    return r.window[0].get("vst_text_upload_seconds_sum")
