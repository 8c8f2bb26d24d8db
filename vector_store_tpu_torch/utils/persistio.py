"""Atomic npz writes for index snapshots (the port's own copy of
vector_store_tpu/utils/persistio.py).

A snapshot interrupted mid-write (process kill, ENOSPC) must not leave a
truncated ``.npz`` at the target path: the next restore sees the file
exists, `np.load` raises `BadZipFile`, and the checkpoint is worse than
absent.  Both helpers write to a sibling temp path and `os.replace`
into place, so the target is always either the old snapshot or the new
one.  (The reference has no persistence at all — SURVEY §5 — so this is
a property of our extension, not a parity behaviour.)

Durability scope: atomic against process kill and ENOSPC.  The temp
file is fsync'd and the directory fsync'd after the rename, so the
snapshot also survives power loss once `save()` returns (without the
directory fsync the rename itself can be lost; without the file fsync
some filesystems journal the rename ahead of the data and expose an
empty target after a crash).
"""

from __future__ import annotations

import itertools
import os
import threading

import numpy as np

# Distinguishes same-path saves racing from two THREADS of one process
# (pid alone would collide — e.g. two indexes snapshotting to one
# user-supplied path; the per-index locks don't cover cross-object
# races on the filesystem).
_seq = itertools.count()
_seq_lock = threading.Lock()


def _effective_target(path: str) -> str:
    # np.savez appends ".npz" when the name lacks it; mirror that so the
    # rename lands where the caller's np.load will look.
    return path if path.endswith(".npz") else path + ".npz"


def _atomic(savefn, path: str, **arrays) -> None:
    target = _effective_target(str(path))
    with _seq_lock:
        n = next(_seq)
    tmp = target[: -len(".npz")] + f".tmp{os.getpid()}.{n}.npz"
    try:
        savefn(tmp, **arrays)
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, target)
        dfd = os.open(os.path.dirname(target) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_savez(path: str, **arrays) -> None:
    """`np.savez` with write-to-temp + rename-into-place semantics."""
    _atomic(np.savez, path, **arrays)


def atomic_savez_compressed(path: str, **arrays) -> None:
    """`np.savez_compressed`, atomic the same way."""
    _atomic(np.savez_compressed, path, **arrays)
