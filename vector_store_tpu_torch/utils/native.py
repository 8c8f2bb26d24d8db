"""ctypes bindings for the serving path's JSON scanners (native/fastjson.cpp),
the vector-file readers and the u64 key map (native/io.cpp) and the CPU
HNSW baseline (native/hnsw.cpp).

The port's own copy of those parts of vector_store_tpu/utils/native.py.
Python's json module costs ~400us to parse one 768-d embedding body; the
scanners read the two hot fields of an ANN request ("embedding": [floats]
and "limit": int) straight off the raw body, and return None on any
structural surprise so that the caller falls back to json.loads.
`read_fvecs` / `read_ivecs` parse the SIFT wire format ([int32 dim][dim
values] per row) for ingest/filesource.py.  `NativeKeyMap` is a u64-hashed
key <-> slot bimap (the engine keeps the Python `KeyMap`), and
`HnswBaseline` a clean-room CPU HNSW, the anchor a benchmark compares the
card against.

Each library is built from its one source file with the host's C++
compiler, at first use, into vector_store_tpu_torch/_build/ (git-ignored),
under a name that carries a hash of the source.  The scanners are optional:
`available()` says whether they loaded, and without a compiler the callers
take the Python parse.  The readers have no Python stand-in: without a
compiler `read_fvecs`, `read_ivecs`, `NativeKeyMap` and `HnswBaseline`
raise RuntimeError.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_libs: dict[str, Optional[ctypes.CDLL]] = {}  # source stem -> library, None: no build


def _build(stem: str) -> Optional[Path]:
    src = _NATIVE_DIR / f"{stem}.cpp"
    if not src.exists():
        return None
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    h = hashlib.sha256(" ".join(_FLAGS).encode() + src.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libvst_{stem}_{h}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(src)], capture_output=True)
        if proc.returncode != 0:
            return None
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _library(stem: str) -> Optional[ctypes.CDLL]:
    """native/<stem>.cpp built and loaded once; None if it cannot be built.
    Call with `_lock` held."""
    if stem not in _libs:
        path = _build(stem)
        _libs[stem] = None if path is None else ctypes.CDLL(str(path))
    return _libs[stem]


def _load() -> Optional[ctypes.CDLL]:
    with _lock:
        fresh = "fastjson" not in _libs
        lib = _library("fastjson")
        if lib is None or not fresh:
            return lib
        lib.json_parse_floats.restype = ctypes.c_long
        lib.json_parse_floats.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
        ]
        lib.json_parse_int.restype = ctypes.c_long
        lib.json_parse_int.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.c_long,
        ]
        return lib


def available() -> bool:
    return _load() is not None


def parse_json_floats(body: bytes, key: bytes, cap: int) -> Optional[np.ndarray]:
    """`"<key>": [floats]` out of a raw JSON body, or None (caller must
    fall back to a full JSON parse: absent key, >cap values, or any
    structural surprise)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(cap, dtype=np.float32)
    n = lib.json_parse_floats(
        body,
        len(body),
        b'"' + key + b'"',
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap,
    )
    if n < 0:
        return None
    return out[:n]


def parse_json_int(body: bytes, key: bytes, default: int) -> Optional[int]:
    """`"<key>": <int>` out of a raw JSON body; `default` when the key is
    absent; None on a malformed value (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    v = lib.json_parse_int(body, len(body), b'"' + key + b'"', default)
    return None if v < 0 else int(v)


def _load_io() -> ctypes.CDLL:
    with _lock:
        fresh = "io" not in _libs
        lib = _library("io")
        if lib is None:
            raise RuntimeError(
                "native/io.cpp could not be built (no C++ compiler, or the source is "
                "missing): the fvecs/ivecs readers and the key map have no "
                "Python stand-in here"
            )
        if fresh:
            c = ctypes
            lib.keymap_create.restype = c.c_void_p
            lib.keymap_free.argtypes = [c.c_void_p]
            lib.keymap_bind.restype = c.c_int32
            lib.keymap_bind.argtypes = [c.c_void_p, c.c_uint64, c.c_int32]
            lib.keymap_unbind.restype = c.c_int32
            lib.keymap_unbind.argtypes = [c.c_void_p, c.c_uint64]
            lib.keymap_slot_of.restype = c.c_int32
            lib.keymap_slot_of.argtypes = [c.c_void_p, c.c_uint64]
            lib.keymap_key_of.restype = c.c_int
            lib.keymap_key_of.argtypes = [c.c_void_p, c.c_int32, c.POINTER(c.c_uint64)]
            lib.keymap_len.restype = c.c_long
            lib.keymap_len.argtypes = [c.c_void_p]
            lib.keymap_bind_batch.argtypes = [
                c.c_void_p,
                c.POINTER(c.c_uint64),
                c.POINTER(c.c_int32),
                c.c_int,
                c.POINTER(c.c_int32),
            ]
            for fn, ctype in ((lib.fvecs_read, ctypes.c_float), (lib.ivecs_read, ctypes.c_int)):
                fn.restype = ctypes.c_long
                fn.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctype),
                    ctypes.c_long,
                    ctypes.POINTER(ctypes.c_int),
                ]
        return lib


def _read_vecs(fn, ctype, dtype, path: str, max_rows: int) -> np.ndarray:
    """The buffer is sized from the file itself (its first int32 is the row
    width, its length bounds the rows), so the reader cannot overrun it."""
    with open(path, "rb") as fh:
        head = fh.read(4)
    if len(head) < 4:
        return np.empty((0, 0), dtype=dtype)
    dims = int(np.frombuffer(head, dtype=np.int32)[0])
    if dims <= 0:
        raise IOError(f"{path}: row width {dims}")
    rows_max = min(max_rows, os.path.getsize(path) // (4 * (dims + 1)))
    buf = np.empty((rows_max, dims), dtype=dtype)
    got = ctypes.c_int(0)
    rows = fn(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctype)), rows_max, ctypes.byref(got))
    if rows < 0:
        raise IOError(f"reading {path} failed: {rows} (-2: rows of unequal width)")
    return buf[:rows]


def read_fvecs(path: str, max_rows: int) -> np.ndarray:
    """Up to `max_rows` rows of an fvecs file as f32 [rows, dims]; the
    width is read from the file."""
    return _read_vecs(_load_io().fvecs_read, ctypes.c_float, np.float32, path, max_rows)


def read_ivecs(path: str, max_rows: int) -> np.ndarray:
    """As read_fvecs, for int32 rows (ground-truth id files)."""
    return _read_vecs(_load_io().ivecs_read, ctypes.c_int, np.int32, path, max_rows)


class NativeKeyMap:
    """u64-hashed key <-> slot bimap backed by native/io.cpp."""

    def __init__(self) -> None:
        self._lib = _load_io()
        self._m = self._lib.keymap_create()

    def bind(self, key: int, slot: int) -> int:
        """Bind key to slot; the slot it displaced, or -1."""
        return self._lib.keymap_bind(self._m, key, slot)

    def bind_batch(self, keys: np.ndarray, slots: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        slots = np.ascontiguousarray(slots, dtype=np.int32)
        out = np.empty_like(slots)
        self._lib.keymap_bind_batch(
            self._m,
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(keys),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out

    def unbind(self, key: int) -> int:
        return self._lib.keymap_unbind(self._m, key)

    def slot_of(self, key: int) -> int:
        return self._lib.keymap_slot_of(self._m, key)

    def key_of(self, slot: int) -> Optional[int]:
        out = ctypes.c_uint64(0)
        if self._lib.keymap_key_of(self._m, slot, ctypes.byref(out)):
            return out.value
        return None

    def __len__(self) -> int:
        return self._lib.keymap_len(self._m)

    def __del__(self) -> None:
        if getattr(self, "_m", None):
            self._lib.keymap_free(self._m)
            self._m = None


_METRICS = {"l2": 0, "cosine": 1, "dot": 2}


def _load_hnsw() -> ctypes.CDLL:
    with _lock:
        fresh = "hnsw" not in _libs
        lib = _library("hnsw")
        if lib is None:
            raise RuntimeError(
                "native/hnsw.cpp could not be built (no C++ compiler, or the source "
                "is missing)"
            )
        if fresh:
            c = ctypes
            lib.hnsw_create.restype = c.c_void_p
            lib.hnsw_create.argtypes = [c.c_int] * 4
            lib.hnsw_free.argtypes = [c.c_void_p]
            lib.hnsw_add.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_int]
            lib.hnsw_search.argtypes = [
                c.c_void_p,
                c.POINTER(c.c_float),
                c.c_int,
                c.c_int,
                c.c_int,
                c.POINTER(c.c_int),
                c.POINTER(c.c_float),
                c.POINTER(c.c_int),
            ]
            lib.hnsw_remove.argtypes = [c.c_void_p, c.c_int]
            lib.hnsw_size.restype = c.c_long
            lib.hnsw_size.argtypes = [c.c_void_p]
        return lib


class HnswBaseline:
    """CPU HNSW (native/hnsw.cpp): the usearch-on-a-CPU role for benchmarks."""

    def __init__(
        self, dims: int, m: int = 16, ef_construction: int = 128, space: str = "cosine"
    ) -> None:
        self._lib = _load_hnsw()
        self.dims = dims
        self._h = self._lib.hnsw_create(dims, m, ef_construction, _METRICS[space])

    def add(self, vectors: np.ndarray) -> None:
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        self._lib.hnsw_add(
            self._h,
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            v.shape[0] if v.ndim == 2 else 1,
        )

    def search(self, queries: np.ndarray, k: int, ef: int = 64) -> tuple[np.ndarray, np.ndarray]:
        """(dist [n, k], ids [n, k] int32); absent results (inf, -1)."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        nq = q.shape[0]
        ids = np.full((nq, k), -1, dtype=np.int32)
        dists = np.full((nq, k), np.inf, dtype=np.float32)
        counts = np.zeros((nq,), dtype=np.int32)
        self._lib.hnsw_search(
            self._h,
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            nq,
            k,
            ef,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            dists.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        return dists, ids

    def remove(self, node_id: int) -> None:
        self._lib.hnsw_remove(self._h, int(node_id))

    def __len__(self) -> int:
        return self._lib.hnsw_size(self._h)

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self._lib.hnsw_free(self._h)
            self._h = None
