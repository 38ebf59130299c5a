"""The port's examples (``examples/torch_quickstart.py``,
``examples/torch_registry.py``, ``examples/torch_spmd_gossip.py``) run
to the end with ``--device cpu`` in an interpreter whose import system
refuses JAX and the JAX package, and without a device on a host with no
card they exit nonzero instead of falling back to the CPU."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

RUN = r"""
import runpy, sys


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "delta_crdt_ex_tpu"):
            raise ImportError(f"{name} is refused in this process")
        return None


sys.meta_path.insert(0, _Refuse())
script = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(script, run_name="__main__")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "delta_crdt_ex_tpu"))
print("JAX_MODULES", bad)
"""

EXAMPLES = {
    "torch_quickstart.py": ([], "replica 2 sees: {'CRDT': 'is magic!'}"),
    "torch_registry.py": (["--names", "256"], "registry demo on cpu: ok"),
    "torch_spmd_gossip.py": ([], "converged: all 8 replicas share digest root"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu_without_jax(name):
    args, want = EXAMPLES[name]
    script = REPO / "examples" / name
    out = subprocess.run(
        [sys.executable, "-c", RUN, str(script), "--device", "cpu", *args],
        capture_output=True, text=True, timeout=240, check=True, cwd=REPO,
    ).stdout
    assert want in out
    assert "JAX_MODULES []" in out


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_without_a_device_needs_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    bare = subprocess.run(
        [sys.executable, str(REPO / "examples" / name)], capture_output=True, text=True, timeout=120, cwd=REPO
    )
    assert bare.returncode != 0 and "CUDA is not available" in bare.stderr
