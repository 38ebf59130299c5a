"""Native host-runtime extensions of the port (C++, built at first use).

- ``fasthash``: batch BLAKE2b key and value hashing (``fasthash.cpp``,
  the port's copy of ``delta_crdt_ex_tpu/native/fasthash.cpp``), bit for
  bit the digests of :mod:`hashlib` that the replicas' per-term path
  computes, so both packages and every replica agree on key ids.

The library builds with ``g++ -O3 -shared -fPIC`` at its first use into
``build/native/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source and the flags, as
:mod:`delta_crdt_ex_tpu_torch.utils.kernels` builds the CUDA kernels: an
edited source rebuilds, an unchanged one is reused, and each build
writes a temporary file and renames it, so that concurrent processes
can build at once. A failed build raises with the compiler's output;
nothing falls back to :mod:`hashlib`. Nothing builds at import.

Every term hashed here is counted (:func:`counts`), so a caller can
check that a path went through the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "fasthash.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_counts = {"hash64": 0, "hash32": 0}


def gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the native hasher builds with the host's C++ compiler")
    return found


def build() -> tuple[Path, str]:
    """``(path, compiler output)`` of the built ``libfasthash-<hash>.so``,
    compiling it if needed (the output is empty for a library already
    built)."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libfasthash-{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [gxx(), *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, proc.stdout


def library() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            lib.hash64_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p]
            lib.hash64_batch.restype = None
            lib.hash32_batch.argtypes = lib.hash64_batch.argtypes
            lib.hash32_batch.restype = None
            _lib = lib
        return _lib


def counts() -> dict:
    """Terms hashed by the library since the last :func:`reset_counts`,
    by function (``hash64``: key ids, ``hash32``: value digests)."""
    with _lock:
        return dict(_counts)


def reset_counts() -> None:
    with _lock:
        for k in _counts:
            _counts[k] = 0


def _pack(blobs: list) -> tuple[np.ndarray, np.ndarray]:
    """The blobs back to back and the ``n + 1`` offsets delimiting them."""
    offsets = np.zeros(len(blobs) + 1, np.uint64)
    np.cumsum(np.fromiter(map(len, blobs), np.uint64, len(blobs)), out=offsets[1:])
    return np.frombuffer(b"".join(blobs) or b"\0", np.uint8), offsets


def _batch(fn: str, dtype, blobs: list) -> np.ndarray:
    out = np.empty(len(blobs), dtype)
    if blobs:
        packed, offsets = _pack(blobs)
        getattr(library(), f"{fn}_batch")(packed.ctypes.data, offsets.ctypes.data, len(blobs), out.ctypes.data)
    with _lock:
        _counts[fn] += len(blobs)
    return out


def hash64_batch(blobs: list) -> np.ndarray:
    """uint64 key ids of canonical encodings: the big-endian BLAKE2b-64
    digest of each, 0 read as 1 (``utils/hashing.py:key_hash64``)."""
    return _batch("hash64", np.uint64, blobs)


def hash32_batch(blobs: list) -> np.ndarray:
    """uint32 value digests of canonical encodings: the big-endian
    BLAKE2b-32 digest of each (``utils/hashing.py:value_hash32``)."""
    return _batch("hash32", np.uint32, blobs)
