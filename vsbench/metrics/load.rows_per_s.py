"""Rows a second that the set-up's load put through the system's entry
(`IndexHandle.add_or_replace_batch`, one message of `load_batch` rows
applied before the next is sent): the engine's actor and executor, the
index's add path (the IVF's reclusters and int8 banks; the graph's insert
blocks, each a beam search with B3), on the host's clock."""


def read(r):
    if r.load_rows <= 0 or r.load_s <= 0:
        return None
    return r.load_rows / r.load_s
