"""Build and load the CUDA kernels of csrc/ at first use.

Each source compiles with its own nvcc process, all started together, and
the objects link into one shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, so a build takes seconds, not
minutes).  Headers (*.cuh) are included by the sources and
count in the hash below.  The library lands in vector_store_tpu_torch/_build/
under a name that carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the existing file.  A failed
build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# nvcc's output of the build this process ran (ptxas register and
# shared-memory report); empty when an existing library was loaded
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # dtype, score, vectors, scales, rowid, queries, cids, nsb,
    # Q, B, D, p, k, space, scaled, vec, ws, out_d, out_r, stream
    "ivf_search_fused": [_I] * 2 + [_P] * 6 + [_I] * 8 + [_P] * 4,
    # cids, N, order, tile_start, tile_n, meta, stream
    "ivf_b1_worklist": [_P, _I] + [_P] * 5,
    # dtype, vectors, scales, rowid, queries, cids, nsb,
    # Q, B, D, p, space, scaled, vec, ws, out, stream
    "ivf_pool_scan": [_I] + [_P] * 6 + [_I] * 8 + [_P] * 3,
    # dtype, vectors, scales, queries, cand,
    # Q, BR, C, D, space, scaled, vec, out, stream
    "graph_gather_score": [_I] + [_P] * 4 + [_I] * 7 + [_P] * 2,
    # dtype, vectors, scales, queries, neighbors, sel_ids, sel_live,
    # Q, B, R, C, D, space, scaled, vec, out_ids, out, stream
    "graph_expand_score": [_I] + [_P] * 6 + [_I] * 8 + [_P] * 3,
    # pd, cand_dist, cand_ids, shift, alpha, M, C, W, n_keep, out_d, out_i, stream
    "graph_robust_prune": [_P] * 4 + [_F] + [_I] * 4 + [_P] * 3,
    # neighbors, nbr_dist, tgt_s, perm, src, d, E, C, R, rounds, stream
    "graph_reverse_edges": [_P] * 6 + [_I] * 4 + [_P],
    # q, bank, nblocks, B, D, score, nbuf, acc, stream
    "copy_probe_stream": [_P] * 2 + [_I] * 5 + [_P] * 2,
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources: list[Path], out: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [out.with_suffix(f".{src.stem}.{os.getpid()}.o") for src in sources]
    nvcc = _nvcc()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for src, o in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    try:
        for cmd, proc, text in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(link)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return "".join(logs)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            sources = _sources()
            out = BUILD_DIR / f"libvst_torch_kernels_{_digest(sources)}.so"
            if not out.exists():
                build_log = _compile(sources, out)
            lib = ctypes.CDLL(str(out))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
