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

import torch

from delta_crdt_ex_tpu_torch.ops.binned import tree_from_leaves


def batched_roots_ref(leaf: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the port's :func:`tree_from_leaves` fold,
    batched over the leading axis."""
    return tree_from_leaves(leaf)[0][..., 0]


class BatchedRootsKernel:
    """The hand-written CUDA kernel ``batched_roots`` (``csrc/roots.cu``).

    Replaces the Pallas TPU kernel ``_roots_kernel`` /
    ``batched_roots_pallas`` (``delta_crdt_ex_tpu/ops/pallas_tree.py:47``,
    ``pallas_call`` at 87).

    Bound on the H100: memory — N·L·8 bytes of leaves read once and N·8
    bytes of roots written, against about 20 integer operations per leaf.
    Design: one block per tree; each thread folds a contiguous aligned
    run of leaves (a whole subtree) in registers, the warp folds its
    threads' subtree roots by shuffles (lower lane = left operand), and
    warp 0 folds the warps' roots from shared memory. It reads the int64
    leaf column as it is (low 32 bits) and writes int64 roots, so no
    conversion pass runs; any power-of-two L ≥ 1 and any N ≥ 1 work (the
    TPU kernel needs L ≥ 128 and pads N to a multiple of 8).

    ``launches`` counts launches; the wrapper builds the library at
    first use and raises on any launch error."""

    name = "batched_roots"
    source = "delta_crdt_ex_tpu_torch/csrc/roots.cu"
    replaces = "delta_crdt_ex_tpu/ops/pallas_tree.py:87"

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None

    def _load(self):
        if self._lib is None:
            from delta_crdt_ex_tpu_torch.utils import kernels

            lib = ctypes.CDLL(str(kernels.build("roots")[0]))
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.batched_roots.argtypes = [p, i64, i64, p, p]
            lib.batched_roots.restype = ctypes.c_int
            lib.roots_error_string.argtypes = [ctypes.c_int]
            lib.roots_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, leaf: torch.Tensor) -> torch.Tensor:
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
        out = torch.empty(n, dtype=torch.int64, device=dev)
        if n == 0:
            return out
        lib = self._load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.batched_roots(leaf.data_ptr(), n, L, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(
                f"batched_roots kernel launch failed: {lib.roots_error_string(err).decode()}"
            )
        self.launches += 1
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
