"""ctypes bindings for the serving path's JSON scanners (native/fastjson.cpp)
and the vector-file readers (native/io.cpp).

The port's own copy of those parts of vector_store_tpu/utils/native.py.
Python's json module costs ~400us to parse one 768-d embedding body; the
scanners read the two hot fields of an ANN request ("embedding": [floats]
and "limit": int) straight off the raw body, and return None on any
structural surprise so that the caller falls back to json.loads.
`read_fvecs` / `read_ivecs` parse the SIFT wire format ([int32 dim][dim
values] per row) for ingest/filesource.py.

Each library is built from its one source file with the host's C++
compiler, at first use, into vector_store_tpu_torch/_build/ (git-ignored),
under a name that carries a hash of the source.  The scanners are optional:
`available()` says whether they loaded, and without a compiler the callers
take the Python parse.  The readers have no Python stand-in: without a
compiler `read_fvecs` and `read_ivecs` raise RuntimeError.
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
                "missing): the fvecs/ivecs readers have no Python stand-in"
            )
        if fresh:
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
