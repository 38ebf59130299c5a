"""Tracing and profiling — the PyTorch port of
``delta_crdt_ex_tpu/runtime/tracing.py``.

The reference's profiling story is dev-time ``:fprof`` wrapped in
``bench/basic_operations.exs:9-23`` (trace 1000 mutations, analyse to a
file). Here:

- :func:`trace` — context manager around any region, capturing a
  ``torch.profiler`` trace (every thread's CPU activity, plus CUDA
  activity when a card is present) written as a Chrome trace into
  ``logdir``;
- :func:`annotate` — a named span, a ``torch.profiler.record_function``
  range on the profiler's timeline, the same clock as the device
  events it launches. It is on only while a torch profiler runs
  (:func:`trace`, ``crdtbench``'s ``--trace 1`` stretch or any other
  ``torch.profiler`` session; :func:`enabled`) and otherwise costs one
  flag check: there is no switch of its own, and no NVTX range (nothing
  reads one);
- :func:`profile_mutations` — the fprof analog: ``n`` mutations against
  a replica, optionally under a trace, and the wall-time split.

The spans:

- the replica paths: ``crdt.flush`` (a local batch), ``crdt.merge`` (one
  received slice), ``crdt.merge_group`` (a coalesced group),
  ``crdt.feed`` (the ``on_diffs`` diff computation and callback);
- anti-entropy (``Replica.sync_to_all``): ``crdt.sync.round`` (a tick's
  push and walks), ``crdt.sync.extract`` (each push's extraction) and
  ``crdt.sync.walk`` (each opened digest walk) inside it;
- the serving front door (``runtime/serve.py``): ``crdt.serve.read``
  (a snapshot read, retries included), ``crdt.serve.publish`` (a
  publication materialised as a read snapshot) and ``crdt.serve.commit``
  (an admission group's ``apply_ops``, on the admission worker's
  thread);
- the merge entry (``models/binned_map.py:tier_retry_merge``, under
  every caller: the fan-in, ``merge_into`` and the replica's merges):
  ``crdt.merge_into`` (the whole call), ``crdt.merge.attempt`` (each
  merge), ``crdt.merge.flags`` (the one flag read a merge, where the
  host waits for the device) and one span an escalation:
  ``crdt.merge.grow.kill``, ``crdt.merge.grow.ins``,
  ``crdt.merge.grow.gid``, ``crdt.merge.compact``,
  ``crdt.merge.grow.bins`` (their count in a trace is the retries by
  reason; ``merge_rows_into``, the replica's row-granular loop, records
  ``crdt.merge.flags``, ``crdt.merge.grow.gid`` and
  ``crdt.merge.grow.bins`` alike); on a CUDA column stack,
  ``crdt.merge.replay`` inside an attempt that replays a captured graph
  (``parallel/merge_graph.py``);
- the merge body's steps, in ``ops/binned.py``'s column merge and
  ``ops/packed.py``'s packed one alike: ``crdt.merge.view``,
  ``crdt.merge.insert_grid``, ``crdt.merge.insert_select``,
  ``crdt.merge.insert_scatter``, ``crdt.merge.insert_aux``,
  ``crdt.merge.kill_rows``, ``crdt.merge.kill_apply``,
  ``crdt.merge.assemble`` (recorded where the torch body runs: on a CPU
  store and on the packed layout; on a CUDA column store an attempt is
  the merge kernel, ``ops/merge_kernel.py``, and has no steps).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any

import torch
from torch.autograd import profiler as _autograd_profiler

#: the Chrome trace file :func:`trace` writes into its ``logdir``
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str, cuda: bool | None = None):
    """Capture a ``torch.profiler`` trace of the enclosed region and
    write it to ``logdir/trace.json`` (Chrome trace format). ``cuda``
    (default: whether a card is available) adds CUDA activity. Yields
    the profiler, whose ``key_averages()`` the caller may read after
    the block."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    # every thread's spans: a replica's commits run on its event loop,
    # on a front door's admission worker and on client threads, not
    # only on the thread that traces
    prof = profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


#: the span :func:`annotate` gives while no profiler runs (reusable)
_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a torch profiler is running, so that spans are recorded.
    Read at each call: the profiler sets the flag as it starts and
    clears it as it stops."""
    return _autograd_profiler._is_profiler_enabled


def annotate(name: str):
    """A named span (a ``torch.profiler.record_function`` range) while a
    profiler runs; otherwise a no-op context that costs one flag
    check."""
    if enabled():
        return torch.profiler.record_function(name)
    return _OFF


def profile_mutations(crdt, n: int = 1000, logdir: str | None = None) -> dict[str, Any]:
    """Profile ``n`` add mutations (reference ``bench/basic_operations.exs:
    9-23``): an optional trace plus the host wall-time split."""
    ctx = trace(logdir) if logdir else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx:
        for x in range(n):
            crdt.mutate("add", [f"key{x}", "value"])
        crdt.hibernate()
    total = time.perf_counter() - t0
    return {
        "mutations": n,
        "total_s": total,
        "per_op_us": total / n * 1e6,
        "trace_dir": logdir,
    }
