"""Tracing and profiling — the PyTorch port of
``delta_crdt_ex_tpu/runtime/tracing.py``.

The reference's profiling story is dev-time ``:fprof`` wrapped in
``bench/basic_operations.exs:9-23`` (trace 1000 mutations, analyse to a
file). Here:

- :func:`trace` — context manager around any region, capturing a
  ``torch.profiler`` trace (every thread's CPU activity, plus CUDA
  activity when a card is present) written as a Chrome trace into
  ``logdir``;
- :func:`annotate` — named spans (``torch.profiler.record_function``,
  inside an NVTX range when CUDA is available) that the replica puts
  around its flush and merge paths: ``crdt.flush``, ``crdt.merge``,
  ``crdt.merge_group``;
- :func:`profile_mutations` — the fprof analog: ``n`` mutations against
  a replica, optionally under a trace, and the wall-time split.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any

import torch

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


@contextlib.contextmanager
def annotate(name: str):
    """Named span visible in profiler traces (and, on a card, in NVTX);
    costs a few microseconds when nothing traces."""
    if torch.cuda.is_available():
        with torch.cuda.nvtx.range(name), torch.profiler.record_function(name):
            yield
    else:
        with torch.profiler.record_function(name):
            yield


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
