"""Digest-tree roots of a batch of leaf arrays — the port of the Pallas
TPU kernel in ``delta_crdt_ex_tpu/ops/pallas_tree.py``
(``_roots_kernel`` / ``batched_roots_pallas``).

:func:`batched_roots` takes ``int64[N, L]`` leaf digests (uint32 values,
L a power of two) and returns ``int64[N]`` roots, each equal to
``tree_from_leaves(leaf[n])[0]``: on a CUDA tensor it launches the
hand-written CUDA kernel in ``csrc/roots.cu`` (or raises), on a CPU
tensor it runs the plain torch :func:`batched_roots_ref`. There is no
probe and no fallback.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from delta_crdt_ex_tpu_torch.ops.binned import tree_from_leaves


def batched_roots_ref(leaf: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the port's :func:`tree_from_leaves` fold,
    batched over the leading axis."""
    return tree_from_leaves(leaf)[0][..., 0]


#: blocks per tree at most (a portable thread-block cluster holds 8)
MAX_CLUSTER = 8


def cluster_size(n: int, L: int, sms: int) -> int:
    """Blocks per tree for the roots kernel: the least power of two C
    with ``N·C ≥ 2·sms`` (two blocks per SM), at most
    :data:`MAX_CLUSTER` and never more than L. C = 8 at the fan-in's
    N = 64 on 132 SMs, C = 1 at N = 4096."""
    c = 1
    while c < MAX_CLUSTER and 2 * c <= L and n * c < 2 * sms:
        c *= 2
    return c


class BatchedRootsKernel:
    """The hand-written CUDA kernel ``batched_roots`` (``csrc/roots.cu``).

    Replaces the Pallas TPU kernel ``_roots_kernel`` /
    ``batched_roots_pallas`` (``delta_crdt_ex_tpu/ops/pallas_tree.py:47``,
    ``pallas_call`` at 87).

    Bound on the H100: memory — N·L·8 bytes of leaves read once and N·8
    bytes of roots written, against about 20 integer operations per leaf.
    Design: a thread-block cluster of C blocks per tree (C from
    :func:`cluster_size`, so that N·C blocks fill the card); each block
    folds the aligned run of L/C leaves that its rank owns (a whole
    subtree), streaming it through shared memory in double-buffered
    2048-leaf tiles with ``cp.async`` (coalesced 16-byte copies, rows
    padded so the fold's reads are free of bank conflicts); each thread
    folds one 8-leaf row in registers, warps fold by shuffles (lower lane
    = left operand), tile roots merge on a register stack, and the C run
    roots meet in rank 0's shared memory through distributed shared
    memory and fold there, lower rank on the left. It reads the int64
    leaf column as it is (low 32 bits) and writes int64 roots, so no
    conversion pass runs; any power-of-two L ≥ 1 and any N ≥ 1 work (the
    TPU kernel needs L ≥ 128 and pads N to a multiple of 8).

    ``launches`` counts launches and ``launches_by_shape`` counts them by
    (N, L); the wrapper builds the library at first use and raises on
    any launch error, a refused cluster launch included. Client threads, admission
    workers and event loops launch it side by side, so the counts move
    under one lock."""

    name = "batched_roots"
    source = "delta_crdt_ex_tpu_torch/csrc/roots.cu"
    replaces = "delta_crdt_ex_tpu/ops/pallas_tree.py:87"

    def __init__(self) -> None:
        self._count_lock = threading.Lock()
        self.launches = 0
        self.launches_by_shape: dict[tuple[int, int], int] = {}
        self._lib = None
        self._sms: dict[int, int] = {}

    def reset(self) -> None:
        """Zero the launch counts."""
        with self._count_lock:
            self.launches = 0
            self.launches_by_shape = {}

    def _count(self, shape: tuple) -> None:
        """Count one launch at ``shape`` (called right after the launch
        succeeded, and from nowhere else)."""
        with self._count_lock:
            self.launches += 1
            self.launches_by_shape[shape] = self.launches_by_shape.get(shape, 0) + 1

    def _load(self):
        if self._lib is None:
            from delta_crdt_ex_tpu_torch.utils import kernels

            lib = ctypes.CDLL(str(kernels.build("roots")[0]))
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.batched_roots.argtypes = [p, i64, i64, ctypes.c_int, p, p]
            lib.batched_roots.restype = ctypes.c_int
            lib.roots_error_string.argtypes = [ctypes.c_int]
            lib.roots_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def cluster_for(self, n: int, L: int, dev: torch.device) -> int:
        """:func:`cluster_size` on ``dev``'s SM count."""
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        if idx not in self._sms:
            self._sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
        return cluster_size(n, L, self._sms[idx])

    def __call__(self, leaf: torch.Tensor, cluster: int | None = None) -> torch.Tensor:
        """Roots of ``leaf``; ``cluster`` forces the blocks per tree (a
        power of two ≤ min(8, L)), else :meth:`cluster_for` picks it."""
        dev = leaf.device
        if dev.type != "cuda":
            raise ValueError(f"batched_roots kernel needs a CUDA tensor, got {dev}")
        if leaf.dtype != torch.int64 or leaf.dim() != 2 or not leaf.is_contiguous():
            raise ValueError(
                f"batched_roots: leaf must be a contiguous 2-D int64 tensor, got "
                f"{leaf.dtype} {tuple(leaf.shape)} (contiguous={leaf.is_contiguous()})"
            )
        n, L = leaf.shape
        if L < 1 or L & (L - 1):
            raise ValueError(f"batched_roots: L must be a power of two, got {L}")
        if leaf.data_ptr() % 16:
            raise ValueError("batched_roots: leaf must start on a 16-byte boundary")
        c = self.cluster_for(n, L, dev) if cluster is None else cluster
        if c < 1 or c > min(MAX_CLUSTER, L) or c & (c - 1):
            raise ValueError(f"batched_roots: cluster {c} is not a power of two in [1, min(8, L={L})]")
        out = torch.empty(n, dtype=torch.int64, device=dev)
        if n == 0:
            return out
        lib = self._load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.batched_roots(leaf.data_ptr(), n, L, c, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(
                f"batched_roots kernel launch failed (cluster {c}): "
                f"{lib.roots_error_string(err).decode()}"
            )
        self._count((n, L))
        return out


#: the process's one roots kernel wrapper (its ``launches`` count is
#: what ``chip_smoke.py`` reads to prove the fan-in went through it)
batched_roots_kernel = BatchedRootsKernel()


def batched_roots(leaf: torch.Tensor) -> torch.Tensor:
    """``int64[N]`` digest-tree roots of ``int64[N, L]`` leaves: the CUDA
    kernel for a CUDA tensor (it launches or raises), the plain torch
    version for a CPU tensor."""
    if leaf.device.type == "cpu":
        return batched_roots_ref(leaf)
    return batched_roots_kernel(leaf)
