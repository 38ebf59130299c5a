"""Run one cell of ``BENCHMARK.json``:

    python3 -m crdtbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets up the cell (its configuration's
driver, fed by the generator from the cell's traffic mix and the seed),
warms up every shape the cell uses, measures a closed loop of calls (or
rounds) for ``--seconds``, and then checks what the timed path produced
against the plain reference. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics
from a profiled stretch of the window), ``device`` and, traced,
``breakdown``; its last key, ``checks``, holds each number compared
beside its limit, and the same lines end standard error.

It exits non-zero, printing no result, where there is no CUDA device or
fewer than the cell asks for, or where JAX or the JAX package is loaded
in the process when the result would be printed (the check is its last
step, after the metric readers and the comparison).

``--control ts32`` runs the comparison's control (see
:mod:`crdtbench.readout`): ``correct`` must come out false.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

#: top-level module names the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "delta_crdt_ex_tpu")


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its CUDA and C++ libraries under ``build/`` by
    itself); no library loads JAX behind the program's back."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv")
    os.environ["USE_FLAX"] = "0"
    # one process with one host thread: the cells are host-bound, and
    # worker pools that spin on a machine whose cores are shared make
    # the host's speed, and so the rate, wander from run to run
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def load_module(path: Path):
    """A module of the harness found by name: ``drivers/<driver>.py`` or
    ``metrics/<metric>.py`` (a metric's name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    name = "crdtbench_found." + path.parent.name + "." + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


class MetricRun:
    """What a per-layer metric's reader gets: the cell, the reduced trace
    (or None), the driver's counters, the inputs' byte counts and the
    window's end-to-end readings (``{name: {"value", "unit"}}``, every
    one the driver took, whether or not the cell reports it)."""

    def __init__(self, cell: dict, trace, counters: dict, work: dict, e2e: dict):
        self.cell, self.trace, self.counters, self.work, self.e2e = cell, trace, counters, work, e2e


def main(argv=None, root=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m crdtbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("ts32",), default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the benchmark); cpu only for the harness's own tests")
    args = ap.parse_args(argv)
    root = Path(root or os.getcwd())

    import torch

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"crdtbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    cuda = args.device == "cuda"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"crdtbench: {args.workload} needs {cell['chips']} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((root / "crdtbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    # the configuration names its driver; a traffic mix that needs another names its own
    driver_name = mix.get("driver", cfg["driver"])
    driver = load_module(root / "crdtbench" / "drivers" / f"{driver_name}.py")

    import delta_crdt_ex_tpu_torch  # noqa: F401  (the program under test: without it, no result)

    from crdtbench.trace import Spans, Tracer

    device = "cuda:0" if cuda else "cpu"
    if cuda:
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
    tracer = Tracer(cuda) if args.trace else None
    trace_steps = int(mix.get("trace_steps", 16))
    steps = 0
    error = run = e2e = None
    window_s = setup_s = 0.0
    try:
        t_cell = time.perf_counter()
        run = driver.Cell(cfg, mix, args.seed, device, Spans(bool(args.trace)))
        setup_s = time.perf_counter() - _T0
        phases = {"imports_and_device": t_cell - _T0, **getattr(run, "setup_phases", {})}
        phases = ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
        print(f"crdtbench: set-up {setup_s:.3f} s ({phases})", file=sys.stderr)
        t_start = t_step = time.perf_counter()
        step_s = []
        while True:
            run.step()
            steps += 1
            now = time.perf_counter()
            step_s.append(now - t_step)
            t_step = now
            if now - t_start >= args.seconds:
                break
        window_s = time.perf_counter() - t_start
        print(f"crdtbench: window {window_s:.3f} s, {steps} steps, {_quartiles(step_s)}", file=sys.stderr)
        e2e = run.end_to_end(window_s)
        if tracer is not None:
            # a traced run profiles trace_steps more steps of the same loop
            # once the window has closed (the profiler's start and stop
            # take seconds, which would otherwise eat the window)
            tracer.start()
            for _ in range(trace_steps):
                run.step()
            tracer.stop()
            tracer.steps = trace_steps
        run.settle()
    except Exception:  # set-up or the timed path failed: no answer, so the run is not correct
        error = traceback.format_exc()
    if tracer is not None:
        tracer.stop()
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0

    device = {"platform": "gpu" if cuda else "cpu", "count": 1, "memory_peak_bytes": mem_peak}
    if cuda:
        from crdtbench.roofline import power_limit_w

        device["kind"] = torch.cuda.get_device_name(0)
        device["name_and_power_limit"] = power_limit_w()
    if error is not None:
        print(error, file=sys.stderr)
        print("check step_errors 1 limit 0", file=sys.stderr)
        attempted = (run.attempted() if run is not None else 0) + 1
        return _print_result({"correct": False, "attempted": attempted, "failed": attempted, "metrics": {},
                              "device": device, "checks": {"step_errors": {"value": 1, "limit": 0}}})

    e2e["device_mem_gib"] = {"value": mem_peak / 2**30, "unit": "GiB"}
    e2e["setup_s"] = {"value": setup_s, "unit": "s"}
    wanted_e2e = [m for m in bench["end_to_end"] if _applies(m, args.workload, {m["name"] for m in bench["end_to_end"]})]
    reported = {m["name"] for m in wanted_e2e}
    result: dict = {}
    if args.trace:
        summary = tracer.reduce()
        ctx = MetricRun(cell, summary, run.counters(), run.work(steps, tracer.steps), e2e)
        metrics = {}
        for m in bench["per_layer"]:
            if not _applies(m, args.workload, reported):
                continue
            value = load_module(root / "crdtbench" / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        missing = [m["name"] for m in wanted_e2e if m["name"] not in e2e]
        if missing:
            raise RuntimeError(f"the {driver_name} driver reports no {missing}")
        metrics = {m["name"]: e2e[m["name"]] for m in wanted_e2e}

    checks, failed = run.judge(args.control)
    correct = all(v <= lim for v, lim in checks.values())
    if args.trace:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result = {
        "correct": correct,
        "attempted": run.attempted(),
        "failed": failed,
        "metrics": metrics,
        "device": device,
        **result,
        "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
    }
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    return _print_result(result)


def _quartiles(values: list) -> str:
    """A step's seconds in the window, for standard error: how far the
    host's pace wandered inside one run."""
    v = sorted(values)
    if len(v) < 2:
        return f"step s {v[0]:.4f}" if v else "no step"
    q1, q2, q3 = statistics.quantiles(v, n=4)
    return f"step s min {v[0]:.4f} q1 {q1:.4f} median {q2:.4f} q3 {q3:.4f} max {v[-1]:.4f}"


def _print_result(result: dict) -> int:
    """The result line, unless the process has loaded JAX or the JAX
    package by now (the run's last step: set-up, the window, the
    metric readers and the comparison have all run)."""
    found = forbidden_modules()
    if found:
        print(f"crdtbench: the process holds {found} after the window; no result", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


def _cli() -> int:
    cache_env(Path(os.getcwd()))
    return main()


if __name__ == "__main__":
    sys.exit(_cli())
