"""A checkout root at a tiny geometry for the harness's CPU tests: the
repository's ``BENCHMARK.json`` and the harness's data and modules,
with each configuration cut to a size a test run holds (the traffic
mixes, drivers and metrics are the real ones, copied)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
HARNESS = REPO / "crdtbench"

TINY = {
    "fullbench-2r-30k": dict(max_sync_size=32, num_buckets=256),
    "propagation-2r-30k": dict(base_keys=1024, num_buckets=256),
}
TINY_MIX = {"add_remove_30k": dict(cycle_keys=256, roots_chunk=40), "add_remove_10": dict(roots_chunk=8)}


def make_root(tmp: Path) -> Path:
    """``tmp`` laid out as a checkout of the benchmark at tiny sizes."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for sub in ("traffic", "drivers", "metrics"):
        shutil.copytree(HARNESS / sub, tmp / "crdtbench" / sub, ignore=shutil.ignore_patterns("__pycache__"))
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(TINY.get(c["name"], {}))
        (tmp / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for name, over in TINY_MIX.items():
        path = tmp / "crdtbench" / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **over}))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run_cell(root: Path, capsys, workload: str, seed: int = 2**33 + 7, seconds: float = 0.5,
             trace: int = 0, control: str | None = None, device: str = "cpu") -> dict:
    """One run of ``workload`` in-process; returns its result line."""
    from crdtbench import run

    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
            "--device", device]
    if control:
        argv += ["--control", control]
    capsys.readouterr()
    rc = run.main(argv, root=root)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0, out
    return json.loads(out[-1])
