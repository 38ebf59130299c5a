#!/usr/bin/env python3
"""Time the port's CUDA kernels of several checkouts in turns, on one
NVIDIA GPU, at the shapes ``chip_smoke.py`` times.

    python3 kernel_times.py . build/parent . build/parent

Each argument is the root of a checkout of this repository (for an
older commit, ``git archive <commit> | tar -x -C build/parent``). Each
runs in a process of its own that imports that checkout's
``delta_crdt_ex_tpu_torch`` (its kernels build into that checkout's
``build/kernels/``) and times it with this checkout's
``chip_smoke.kernel_timings``: the probe lookup at ``PROBE_TIMED`` and
the roots fold at ``ROOTS_TIMED``, L2 flushed between calls, each
kernel's duration by the profiler (and by CUDA events at the first
shape), beside the plain versions and the byte bounds. A checkout older
than ``delta_crdt_ex_tpu_torch/utils/probe_tables.py`` gets this one's
table builder, so every run times the same seeded tables. Runs in turns
(A, B, B, A) on one card compare two versions; two calls may land on
different cards. The last line is JSON: every run's rows, in order.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def one(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import delta_crdt_ex_tpu_torch

    if Path(delta_crdt_ex_tpu_torch.__file__).resolve().parent.parent != tree:
        raise RuntimeError(f"imported {delta_crdt_ex_tpu_torch.__file__}, not the port of {tree}")
    tables = "delta_crdt_ex_tpu_torch/utils/probe_tables.py"
    if not (tree / tables).exists():
        name = tables[:-3].replace("/", ".")
        spec = importlib.util.spec_from_file_location(name, HERE / tables)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    spec = importlib.util.spec_from_file_location("kernel_timing_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: kernel times come from the card only")
    card = smoke.gpu_name_power()
    return {"tree": str(tree), "card": card, "rows": smoke.kernel_timings(card)}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    trees = [Path(t).resolve() for t in sys.argv[1:]]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", str(tree)],
                              stdout=subprocess.PIPE, text=True)
        out = proc.stdout.strip().splitlines()
        print("\n".join(out[:-1]), flush=True)
        if proc.returncode != 0 or not out:
            print(f"kernel_times: the run of {tree} failed ({proc.returncode})", file=sys.stderr)
            return 1
        runs.append(json.loads(out[-1]))
    for kern in ("probe", "roots"):
        for i, row in enumerate(runs[0]["rows"][kern]):
            times = [r["rows"][kern][i]["kernel_ms"] for r in runs]
            print(f"[ab] {kern} {row['shape']}: kernel ms by run {times} (bound {row['bound_ms']:.6f})",
                  flush=True)
    print(json.dumps(runs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
