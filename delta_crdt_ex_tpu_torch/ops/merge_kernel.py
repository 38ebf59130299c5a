"""The hand-written CUDA kernel of the column fan-in's merge attempt
(``csrc/merge.cu``): a delta slice merged into a lane-batched column
store in place, written only where ``ok`` holds, with the attempt's
per-lane flags and counts in two small buffers.

:data:`merge_slice_kernel` launches it (or raises) on a CUDA store; it
is reached through :func:`~delta_crdt_ex_tpu_torch.ops.binned.merge_commit`
(a merge attempt of
:mod:`~delta_crdt_ex_tpu_torch.parallel.merge_graph`) and through
:func:`~delta_crdt_ex_tpu_torch.ops.binned.merge_slice` on a CUDA store.
Its plain torch twin, which runs for CPU stores, is
:func:`~delta_crdt_ex_tpu_torch.ops.binned.merge_commit_ref`. There is
no fallback.

Contract of the kernel with the plain op: every flag and ``n_inserted``
equal on every attempt (they drive ``tier_retry_merge``), the merged
store and ``n_killed`` equal wherever ``ok`` holds, and the store
untouched where not (the plain op's partial state there is never read).
Precondition, as for the plain op's scatters: the slice's rows name
distinct buckets, except negative padding.

This module checks what the kernel takes from Python: dtypes, shapes,
contiguity and device. The kernel's limits and the layout of its
scratch live in ``csrc/merge.cu`` alone (``merge_scratch_bytes``
refuses a shape past them, and :func:`MergeSliceKernel.limits` reads
them).
"""

from __future__ import annotations

import ctypes
import threading
from typing import TYPE_CHECKING

import torch

from delta_crdt_ex_tpu_torch.models.binned import COLUMNS, BinnedStore

if TYPE_CHECKING:
    from delta_crdt_ex_tpu_torch.ops.binned import RowSlice

#: rows of the flags buffer (``MergeResult``'s booleans) and of the
#: counts buffer (``n_inserted``, ``n_killed``)
N_FLAGS, N_COUNTS = 6, 2

#: each store column's dtype, in :data:`COLUMNS` order
STORE_DTYPES = {
    "key": torch.int64, "valh": torch.int64, "ts": torch.int64, "node": torch.int32,
    "ctr": torch.int64, "alive": torch.bool, "ehash": torch.int64, "fill": torch.int32,
    "amin": torch.int64, "amax": torch.int64, "leaf": torch.int64, "ctx_gid": torch.int64,
    "ctx_max": torch.int64,
}
#: each slice column's dtype, in ``RowSlice`` order
SLICE_DTYPES = {
    "rows": torch.int64, "key": torch.int64, "valh": torch.int64, "ts": torch.int64,
    "node": torch.int32, "ctr": torch.int64, "alive": torch.bool, "ctx_rows": torch.int64,
    "ctx_lo": torch.int64, "ctx_gid": torch.int64,
}


def check_args(x: BinnedStore, sl: RowSlice, flags: torch.Tensor, counts: torch.Tensor) -> tuple:
    """``(N, L, B, R, U, S, Rr, slice has a lane axis)`` after checking
    the dtypes, shapes, contiguity and device of what the kernel takes;
    raises ``ValueError`` on anything else. The sizes are checked
    against the kernel's limits at launch."""
    if x.ctx_gid.dim() != 2:
        raise ValueError(f"merge kernel: the store needs a lane axis, got a writer table of {tuple(x.ctx_gid.shape)}")
    n, L, B = x.key.shape
    R = x.ctx_gid.shape[1]
    want = {
        "key": (n, L, B), "valh": (n, L, B), "ts": (n, L, B), "node": (n, L, B), "ctr": (n, L, B),
        "alive": (n, L, B), "ehash": (n, L, B), "fill": (n, L), "amin": (n, L, R), "amax": (n, L, R),
        "leaf": (n, L), "ctx_gid": (n, R), "ctx_max": (n, L, R),
    }
    for c in COLUMNS:
        _check(f"store.{c}", getattr(x, c), STORE_DTYPES[c], want[c], x.device)
    lanes = sl.key.dim() == 3
    lead = (n,) if lanes else ()
    if sl.key.dim() not in (2, 3) or sl.key.shape[:-2] != lead:
        raise ValueError(f"merge kernel: slice key must be [U, S] or [{n}, U, S], got {tuple(sl.key.shape)}")
    u, s = sl.key.shape[-2:]
    rr = sl.ctx_gid.shape[-1]
    want_sl = {
        "rows": (*lead, u), "key": (*lead, u, s), "valh": (*lead, u, s), "ts": (*lead, u, s),
        "node": (*lead, u, s), "ctr": (*lead, u, s), "alive": (*lead, u, s), "ctx_rows": (*lead, u, rr),
        "ctx_lo": (*lead, u, rr), "ctx_gid": (*lead, rr),
    }
    for c, dtype in SLICE_DTYPES.items():
        _check(f"slice.{c}", getattr(sl, c), dtype, want_sl[c], x.device)
    _check("flags", flags, torch.bool, (N_FLAGS, n), x.device)
    _check("counts", counts, torch.int64, (N_COUNTS, n), x.device)
    return n, L, B, R, u, s, rr, lanes


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"merge kernel: {name} must be {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"merge kernel: {name} must be contiguous")
    if t.device != device:
        raise ValueError(f"merge kernel: {name} is on {t.device}, the store on {device}")


class MergeSliceKernel:
    """The hand-written CUDA kernel ``merge_slice_commit``
    (``csrc/merge.cu``): one merge attempt in two launches over only the
    slice's rows.

    Replaces no TPU kernel: the JAX package's column merge
    (``delta_crdt_ex_tpu/ops/binned.py:merge_slice``) is jnp that XLA
    fuses; in plain torch the same merge is hundreds of small kernels,
    each a pass over the whole store (every output column a fresh copy),
    and nothing in PyTorch fuses it.

    Bound on the H100: the bytes of the touched rows (read once, written
    once, and through the scratch) plus two launch latencies; a few
    hundred integer operations a slot. Design: a memset zeroes the
    per-lane words, then the compute pass reads the store and writes
    each slice row's new contents to a scratch, one warp a row, with the
    per-lane counts and flags gathered by atomics into those words; the
    commit pass writes the flags and counts and, only where ``ok`` holds
    (every lane's, or each lane's own with ``per_lane``), copies the
    scratch rows and the merged writer tables into the store. Nothing
    outside the slice's rows is read or written, and no merged column is
    ever allocated. The scratch, per-lane words included, is one buffer
    an attempt (in the graph's pool under a capture) whose size and
    layout the library gives.

    ``launches`` counts attempts launched to run at once; one recorded
    into a CUDA graph under capture is not counted (it runs at every
    replay, which :mod:`~delta_crdt_ex_tpu_torch.parallel.merge_graph`
    counts). The wrapper builds the library at first use and raises on
    any launch error. Launched from several threads, so the count moves
    under a lock."""

    name = "merge_slice_commit"
    source = "delta_crdt_ex_tpu_torch/csrc/merge.cu"
    replaces = None

    def __init__(self) -> None:
        self._count_lock = threading.Lock()
        self._load_lock = threading.Lock()
        self.launches = 0
        self._lib = None

    def _load(self):
        with self._load_lock:
            if self._lib is None:
                from delta_crdt_ex_tpu_torch.utils import kernels

                lib = ctypes.CDLL(str(kernels.build("merge")[0]))
                p = ctypes.c_void_p
                lib.merge_slice_commit.argtypes = [p, p, p, p, p, p, p]
                lib.merge_slice_commit.restype = ctypes.c_int
                lib.merge_scratch_bytes.argtypes = [p]
                lib.merge_scratch_bytes.restype = ctypes.c_int64
                lib.merge_limits.argtypes = []
                lib.merge_limits.restype = ctypes.c_char_p
                lib.merge_init.argtypes = []
                lib.merge_init.restype = ctypes.c_int
                lib.merge_error_string.argtypes = [ctypes.c_int]
                lib.merge_error_string.restype = ctypes.c_char_p
                err = lib.merge_init()
                if err != 0:
                    raise RuntimeError(f"merge kernel: setting its shared memory failed: {lib.merge_error_string(err).decode()}")
                self._lib = lib
        return self._lib

    def reset(self) -> None:
        """Zero the launch count."""
        with self._count_lock:
            self.launches = 0

    def limits(self) -> str:
        """The kernel's size limits, as the library states them."""
        return self._load().merge_limits().decode()

    def __call__(
        self, x: BinnedStore, sl: RowSlice, kill_budget: int, max_inserts: int | None, flags, counts,
        per_lane: bool = False,
    ) -> None:
        """One attempt: see
        :func:`~delta_crdt_ex_tpu_torch.ops.binned.merge_commit`. With
        ``per_lane`` each ok lane is committed on its own, else only an
        attempt where every lane is ok. The scratch is allocated here, in
        the graph's pool under a capture."""
        if x.device.type != "cuda":
            raise ValueError(f"merge kernel needs a CUDA store, got {x.device}")
        n, L, B, R, u, s, rr, lanes = check_args(x, sl, flags, counts)
        lib = self._load()
        dims = (ctypes.c_int64 * 11)(
            n, L, B, R, u, s, rr, int(kill_budget), -1 if max_inserts is None else int(max_inserts), int(lanes),
            int(per_lane),
        )
        nbytes = lib.merge_scratch_bytes(dims)
        if nbytes < 0:
            raise ValueError(
                f"merge kernel: N = {n}, L = {L}, B = {B}, R = {R}, U = {u}, S = {s}, Rr = {rr} is past its limits "
                f"({self.limits()}) or empty"
            )
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        store = (ctypes.c_void_p * 13)(*(getattr(x, c).data_ptr() for c in COLUMNS))
        slice_p = (ctypes.c_void_p * 10)(*(getattr(sl, c).data_ptr() for c in SLICE_DTYPES))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.merge_slice_commit(
            dims, store, slice_p, scratch.data_ptr(), flags.data_ptr(), counts.data_ptr(), stream
        )
        if err != 0:
            raise RuntimeError(f"merge kernel launch failed: {lib.merge_error_string(err).decode()}")
        if not torch.cuda.is_current_stream_capturing():
            with self._count_lock:
                self.launches += 1


#: the process's one merge kernel wrapper (its ``launches`` count, beside
#: ``merge_graph.replays``, says how many attempts ran through it)
merge_slice_kernel = MergeSliceKernel()
