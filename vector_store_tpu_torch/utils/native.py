"""ctypes bindings for the serving path's JSON scanners (native/fastjson.cpp).

The port's own copy of the fastjson part of vector_store_tpu/utils/native.py.
Python's json module costs ~400us to parse one 768-d embedding body; these
scanners read the two hot fields of an ANN request ("embedding": [floats]
and "limit": int) straight off the raw body, and return None on any
structural surprise so that the caller falls back to json.loads.

The library is built from the repo's native/fastjson.cpp alone with the
host's C++ compiler, at first use, into vector_store_tpu_torch/_build/
(git-ignored), under a name that carries a hash of the source.  It is
optional: `available()` says whether it loaded, and without a compiler
the callers take the Python parse.
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

_SRC = Path(__file__).resolve().parents[2] / "native" / "fastjson.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[Path]:
    if not _SRC.exists():
        return None
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libvst_fastjson_{h}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC)], capture_output=True)
        if proc.returncode != 0:
            return None
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
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
        _lib = lib
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
