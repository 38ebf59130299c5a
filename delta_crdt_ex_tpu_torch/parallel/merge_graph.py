"""The column fan-in's merge attempts replayed as CUDA graphs.

On a CUDA column stack, :func:`~delta_crdt_ex_tpu_torch.parallel.batched_sync.fanout_merge_into`
runs its tier-retry loop
(:func:`~delta_crdt_ex_tpu_torch.models.binned_map.tier_retry_merge`,
policy and retry counts unchanged) through a :class:`MergeGraphs`: each
merge attempt, and each compaction, is one replay of a captured graph
instead of every op enqueued from Python. A merge attempt's graph holds
a memset and the two launches of the hand-written merge kernel
(:func:`~delta_crdt_ex_tpu_torch.ops.binned.merge_commit`,
``csrc/merge.cu``); a compaction's, the torch ops of
:func:`~delta_crdt_ex_tpu_torch.ops.binned.compact_rows`. The results are
the eager path's bit for bit (integer arithmetic only).

Buffers. The entry owns the stack it returned last (X) and, for each
slice shape, a static copy of the slice, into which each call's slice is
copied once. A merge graph reads X and the static slice; it writes the
attempt's per-lane flags and counts into two small entry-owned buffers
(:func:`~delta_crdt_ex_tpu_torch.ops.binned.result_buffers`) and,
only where every lane merged (``ok`` on the device), the merged rows
into X in place: the kernel writes the slice's rows of X and nothing
else, and no merged column exists anywhere. The graphs share one
private memory pool, which holds the compaction's temporaries and each
merge graph's scratch of the slice's rows (with the kernel's per-lane
words, zeroed at the head of every attempt, so an attempt that failed
part way leaves nothing a later one reads). An attempt that needs a
higher tier leaves X as it was, so the retry replays another graph on
the same X. No graph output lives in the pool, so any replay order is
safe.

Keys: the slice's shape and dtypes, the kill budget and the insert tier
(one graph each), and one key for the compaction; a graph is captured
on first use. Its first run is that attempt itself, eagerly on a side
stream (the warm-up), and the capture then records without running.
Adopting a new X (a stack the entry did not return: the first call, a
caller's own stack, a grown geometry, merged eagerly) drops the old X,
the graphs and the static slices.

The counters are plain integers on this module: :data:`captures`,
:data:`replays` (merge attempts replayed) and :data:`eager_attempts`
(merge attempts run eagerly: on a stack the entry did not return, and
the first run of each graph). On a CUDA stack every eager attempt is
one launch of the merge kernel, so its ``launches`` count plus
:data:`replays` is every attempt. Under a profiler each replayed attempt
is a ``crdt.merge.replay`` span inside its ``crdt.merge.attempt``.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref

import torch

from delta_crdt_ex_tpu_torch.models.binned import COLUMNS, BinnedStore
from delta_crdt_ex_tpu_torch.models.binned_map import tier_retry_merge
from delta_crdt_ex_tpu_torch.ops.binned import (
    FLAGS,  # the flags buffer's rows, in MergeResult order
    MergeResult,
    RowSlice,
    compact_rows,
    merge_commit,
    merge_slice,
    result_buffers,
)
from delta_crdt_ex_tpu_torch.runtime import tracing

#: graphs captured (merge attempts and compactions)
captures = 0
#: merge attempts run as a graph replay
replays = 0
#: merge attempts run eagerly by the entry (a stack it did not return,
#: or the first run of a graph)
eager_attempts = 0

#: one merge attempt as its graph runs it (see
#: :func:`~delta_crdt_ex_tpu_torch.ops.binned.merge_commit`)
merge_body = merge_commit


def compact_body(x: BinnedStore) -> None:
    """:func:`~delta_crdt_ex_tpu_torch.ops.binned.compact_rows` of ``x``,
    written over ``x``."""
    packed = compact_rows(x)
    for c in COLUMNS:
        col, new = getattr(x, c), getattr(packed, c)
        if new is not col:
            col.copy_(new)


def capture_cuda(body, device: torch.device, pool) -> torch.cuda.CUDAGraph:
    """Run ``body`` once (the warm-up, on a side stream), then capture it
    into a graph in ``pool``; the capture records and does not run."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        main = torch.cuda.current_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            body()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            body()
    return graph


class MergeGraphs:
    """The column fan-in's merge entry on captured graphs (see the module
    docstring). :meth:`merge_into` has ``tier_retry_merge``'s arguments
    and result. ``capture(body, device, pool)`` runs ``body`` once and
    returns an object whose ``replay()`` runs it again (a test may pass
    one that replays eagerly); the graphs of one X share one pool (none
    on a CPU store)."""

    def __init__(self, capture=capture_cuda):
        self._capture_fn = capture
        self._lock = threading.RLock()
        self._last = None  # weak reference to the stack object returned last
        # stack objects returned and since passed in again (consumed), by id
        self._stale = weakref.WeakValueDictionary()
        self._sl_static = None
        self._drop()

    def _drop(self) -> None:
        self._x = None  # X, as a store object of the entry's own
        self._graphs: dict = {}
        self._slices: dict = {}
        self._pool = None
        self._flags = self._counts = None

    def _dropped(self, ref) -> None:
        """The last stack returned was freed: nothing can pass X in again."""
        with self._lock:
            if ref is self._last:
                self._drop()

    def _adopt(self, state: BinnedStore) -> None:
        self._drop()
        self._x = dataclasses.replace(state)
        self._flags, self._counts = result_buffers(state.key.shape[0], state.device)

    def _graph(self, key, body):
        """``(graph, whether this call captured it)``."""
        global captures
        g = self._graphs.get(key)
        if g is not None:
            return g, False
        if self._pool is None and self._x.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
        g = self._graphs[key] = self._capture_fn(body, self._x.device, self._pool)
        captures += 1
        return g, True

    def _static_slice(self, sl: RowSlice):
        """``(shape key, static copy)`` of this call's slice, filled once a
        call."""
        if self._sl_static is None:
            sig = tuple((tuple(t.shape), t.dtype) for t in sl)
            static = self._slices.get(sig)
            if static is None:
                static = self._slices[sig] = RowSlice(
                    *(torch.empty(t.shape, dtype=t.dtype, device=self._x.device) for t in sl)
                )
            for dst, src in zip(static, sl):
                dst.copy_(src)
            self._sl_static = sig, static
        return self._sl_static

    def _merge(self, state, sl, kill_budget, max_inserts) -> MergeResult:
        global replays, eager_attempts
        if state is not self._x:
            eager_attempts += 1
            return merge_slice(state, sl, kill_budget, max_inserts)
        sig, static = self._static_slice(sl)
        g, first = self._graph(
            ("merge", sig, kill_budget, max_inserts),
            lambda: merge_body(self._x, static, kill_budget, max_inserts, self._flags, self._counts),
        )
        if first:
            eager_attempts += 1
        else:
            with tracing.annotate("crdt.merge.replay"):
                g.replay()
            replays += 1
        return MergeResult(self._x, *self._flags.unbind(0), *self._counts.unbind(0))

    def _compact(self, state):
        if state is not self._x:
            return compact_rows(state)
        g, first = self._graph(("compact",), lambda: compact_body(self._x))
        if not first:
            g.replay()
        return self._x

    def merge_into(self, stacked: BinnedStore, sl: RowSlice, kill_budget: int, max_inserts: int, on_grow=None):
        with self._lock:
            if self._stale.get(id(stacked)) is stacked:
                raise ValueError(
                    "this stack was returned by the merge entry and has since been passed in again, "
                    "which consumed it: pass the stack that the last call returned"
                )
            donated = self._last is not None and stacked is self._last()
            try:
                new, res, retries = tier_retry_merge(
                    self._x if donated else stacked, sl, self._merge, self._compact,
                    kill_budget, max_inserts, on_grow=on_grow,
                )
            finally:
                self._sl_static = None
            if new is self._x:
                # X holds the result: the caller gets a stack object of its
                # own on it, and flags of its own
                new = dataclasses.replace(self._x)
                res = MergeResult(new, *self._flags.clone().unbind(0), *self._counts.clone().unbind(0))
            else:
                self._adopt(new)
            if donated:
                self._stale[id(stacked)] = stacked
            self._last = weakref.ref(new, self._dropped)
            return new, res, retries


#: the entry that ``fanout_merge_into`` uses for CUDA column stacks
ENTRY = MergeGraphs()
