"""Build the port's hand-written CUDA kernels from the sources in
``delta_crdt_ex_tpu_torch/csrc/``: ``probe.cu`` (the probe-window point
lookup), ``roots.cu`` (the digest-tree roots) and ``merge.cu`` (the
column fan-in's merge attempt).

Each source ``csrc/<name>.cu`` compiles with its own ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded
with ``ctypes`` by the op module that wraps it. Libraries go to
``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one is reused. Nothing builds
at import: :func:`build` runs at a kernel's first launch, or earlier
for a caller that wants the build up front; :func:`build_all` starts
one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build(name: str, verbose: bool = False) -> tuple[Path, str]:
    """``(path, nvcc output)`` of the built ``lib<name>.so``, compiling
    it if needed (the output is empty for a library already built).
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills
    per kernel in the output)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if out.exists():
            return out, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        extra = ("-Xptxas", "-v") if verbose else ()
        cmd = [nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        return out, proc.stdout


def build_all(verbose: bool = False) -> dict[str, tuple[Path, str]]:
    """:func:`build` of every source ``csrc/<name>.cu``, one ``nvcc``
    each, all started together; raises the first failure."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(lambda n: build(n, verbose), names)))
