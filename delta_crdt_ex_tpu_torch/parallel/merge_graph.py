"""The column fan-in's merge attempts replayed as CUDA graphs.

On a CUDA column stack, :func:`~delta_crdt_ex_tpu_torch.parallel.batched_sync.fanout_merge_into`
runs its tier-retry loop
(:func:`~delta_crdt_ex_tpu_torch.models.binned_map.tier_retry_merge`,
policy and retry counts unchanged) through a :class:`MergeGraphs`: each
merge attempt, and each compaction, is one replay of a graph captured
from the same torch ops the eager merge runs
(:func:`~delta_crdt_ex_tpu_torch.ops.binned.merge_slice`,
:func:`~delta_crdt_ex_tpu_torch.ops.binned.compact_rows`), instead of
every op enqueued from Python. The results are the eager path's bit for
bit: the same ops in the same order, integer arithmetic only.

Buffers. The entry owns the stack it returned last (X) and, for each
slice shape, a static copy of the slice, into which each call's slice is
copied once. A graph reads X and the static slice; it writes the
attempt's per-lane flags and counts into two small entry-owned buffers
and, only where every lane merged (``ok`` on the device), the merged
columns over X; an attempt that needs a higher tier leaves X as it was,
so the retry replays another graph on the same X. The merge's output
columns are temporaries of the graph, in one private memory pool that
all the entry's graphs share: no graph output lives in the pool, so any
replay order is safe, and X plus the pool is what the eager merge holds
(its input and its output).

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
the first run of each graph). Under a profiler each replayed attempt is
a ``crdt.merge.replay`` span inside its ``crdt.merge.attempt``; the
merge body's step spans appear only on eager attempts and at capture.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref

import torch

from delta_crdt_ex_tpu_torch.models.binned import COLUMNS, BinnedStore
from delta_crdt_ex_tpu_torch.models.binned_map import tier_retry_merge
from delta_crdt_ex_tpu_torch.ops.binned import (
    MergeResult,
    RowSlice,
    _lane_slice,
    _merge_slice_b,
    compact_rows,
    merge_slice,
)
from delta_crdt_ex_tpu_torch.runtime import tracing

#: graphs captured (merge attempts and compactions)
captures = 0
#: merge attempts run as a graph replay
replays = 0
#: merge attempts run eagerly by the entry (a stack it did not return,
#: or the first run of a graph)
eager_attempts = 0

#: the boolean fields of a :class:`MergeResult` (the flags buffer's rows)
#: and its two counts (the counts buffer's)
FLAGS, COUNTS = MergeResult._fields[1:-2], MergeResult._fields[-2:]


def merge_body(x: BinnedStore, sl: RowSlice, kill_budget: int, max_inserts: int | None, flags, counts) -> None:
    """One merge attempt as its graph runs it: ``sl`` merged into the
    lane-batched store ``x``; the per-lane :data:`FLAGS` into ``flags``
    (bool ``[6, N]``) and ``n_inserted``, ``n_killed`` into ``counts``
    (int64 ``[2, N]``); and where every lane is ok, the merged columns
    written over ``x``, else ``x`` left as it was. Plain torch ops, no
    host sync: it runs eagerly as well."""
    res = _merge_slice_b(x, _lane_slice(sl, x.key.shape[0]), kill_budget, max_inserts)
    ok = res.ok.all()
    for c in COLUMNS:
        col = getattr(x, c)
        torch.where(ok, getattr(res.state, c), col, out=col)
    torch.stack([getattr(res, f) for f in FLAGS], out=flags)
    torch.stack([getattr(res, f) for f in COUNTS], out=counts)


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
        n, dev = state.key.shape[0], state.device
        self._flags = torch.empty((len(FLAGS), n), dtype=torch.bool, device=dev)
        self._counts = torch.empty((len(COUNTS), n), dtype=torch.int64, device=dev)

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
                static = self._slices[sig] = RowSlice(*(torch.empty_like(t, device=self._x.device) for t in sl))
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
