"""What the harness may import and read: no module under ``crdtbench/``
loads JAX, jaxlib, flax or the JAX package (top-level names compared
whole: ``delta_crdt_ex_tpu_torch`` begins with the JAX package's name);
the reference imports nothing of the program; nothing reads the JAX
package's benchmarks; and a run whose metric reader loads a module
named ``jax`` prints no result."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from crdtbench.tests.tiny import HARNESS, REPO, make_root

FORBIDDEN = {"jax", "jaxlib", "flax", "delta_crdt_ex_tpu"}
SOURCES = sorted(p for p in HARNESS.rglob("*.py") if "__pycache__" not in p.parts)


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_imports_jax_or_the_jax_package():
    for p in SOURCES:
        assert not (_imported_roots(p) & FORBIDDEN), p


def test_reference_imports_nothing_of_the_program():
    for p in (HARNESS / "reference").glob("*.py"):
        assert "delta_crdt_ex_tpu_torch" not in _imported_roots(p), p


def test_nothing_reads_the_jax_benchmarks():
    for p in SOURCES:
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        assert "benchmarks/" not in text and "bench.py" not in text, p


def test_loading_every_module_loads_no_jax():
    """A fresh interpreter that imports the harness and loads every
    driver and metric module holds none of the forbidden names."""
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "import crdtbench.run as run, crdtbench.gen, crdtbench.readout, crdtbench.roofline, crdtbench.trace\n"
        "import crdtbench.reference.awlww, crdtbench.reference.compare, crdtbench.reference.digest\n"
        f"h = Path({str(HARNESS)!r})\n"
        "for sub in ('drivers', 'metrics'):\n"
        "    for p in sorted((h / sub).glob('*.py')):\n"
        "        run.load_module(p)\n"
        "import delta_crdt_ex_tpu_torch.parallel.batched_sync, delta_crdt_ex_tpu_torch.utils.synth\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not (loaded & FORBIDDEN), loaded & FORBIDDEN
    assert "delta_crdt_ex_tpu_torch" in loaded


def test_a_jax_load_by_a_metric_reader_prints_no_result(tmp_path):
    """The check for JAX is the run's last step: a per-layer metric's
    reader that imports a (stub) module named ``jax`` leaves the run
    without a result line and with a non-zero exit."""
    root = make_root(tmp_path / "root")
    stubs = tmp_path / "stubs" / "jax"
    stubs.mkdir(parents=True)
    (stubs / "__init__.py").write_text("")
    (root / "crdtbench/metrics/loads_jax.py").write_text("def read(run):\n    import jax  # noqa: F401\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    bench["per_layer"].append({"name": "loads_jax", "unit": "n", "better": "lower", "source": "program_counter",
                               "layer": "merge entry", "moves": "merges_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys\n"
        "from crdtbench import run\n"
        f"sys.exit(run.main(['--workload', {cell!r}, '--seed', '3', '--seconds', '0.2', '--trace', '1',"
        f" '--device', 'cpu'], root={str(root)!r}))\n"
    )
    env = {**__import__("os").environ, "PYTHONPATH": f"{tmp_path / 'stubs'}:{REPO}"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0, proc.stdout
    assert "correct" not in proc.stdout
    assert "jax" in proc.stderr
