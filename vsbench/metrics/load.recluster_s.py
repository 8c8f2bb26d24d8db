"""Seconds the IVF's reclusters took in the set-up's load: the span
`vst_ivf_recluster_seconds` (core/ivf.py, each k-means and permutation of
the bank as the live count doubles), over both paths of the permutation
(label `via`, device or host); 0 where the IVF placed rows and never
reclustered.  Read at the window's start, when it holds the whole load."""


def read(r):
    before = r.window[0]
    if "vst_ivf_place_seconds_count" not in before:
        return None
    return before.get("vst_ivf_recluster_seconds_sum", 0.0)
