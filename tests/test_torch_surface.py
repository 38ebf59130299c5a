"""The port's public surface against the JAX package's, read with ``ast``.

Neither package is imported. For every module of ``delta_crdt_ex_tpu``
that has a counterpart file in ``delta_crdt_ex_tpu_torch``, every public
top-level name the JAX module defines (or lists in ``__all__``) must be
bound in the port's module, and every public method and class attribute
of a class that both modules define must exist on the port's class.
``EXCLUDED`` lists each name the port leaves out on purpose, with its
reason. The JAX modules without a counterpart file must be exactly the
ones ``ROADMAP.md`` lists under "Not ported, by choice".
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "delta_crdt_ex_tpu"
PORT = ROOT / "delta_crdt_ex_tpu_torch"

#: JAX module -> the port file that takes its place under another name
RENAMED = {"ops/pallas_tree.py": "ops/roots.py"}

_JIT = "torch compiles nothing per shape: the plain function is the entry point"

#: (JAX module, name) -> why the port leaves it out; a name ending in
#: ``*`` covers every name of that prefix
EXCLUDED = {
    ("models/binned_map.py", "jit_*"): _JIT,
    ("models/hash_store.py", "jit"): _JIT + " (the jitted-op namespace)",
    ("parallel/batched_sync.py", "jit_*"): _JIT,
    ("runtime/transition.py", "jit_*"): _JIT,
    ("ops/hash_map.py", "probe_lookup_pallas"): "the Pallas entry point; the port's kernel is ProbeLookupKernel",
    ("ops/hash_map.py", "probed_lookup_fn"): "a per-shape Pallas factory; ProbeLookupKernel takes every shape",
    ("ops/pallas_tree.py", "batched_roots_pallas"): "the Pallas entry point; the port's kernel is BatchedRootsKernel",
    ("ops/pallas_tree.py", "batched_roots_fn"): "a per-shape compiled factory; batched_roots takes every L",
    ("runtime/telemetry.py", "JIT_COMPILE"): "torch compiles nothing per shape, so no compile event exists",
    ("utils/devices.py", "backend_initialised"): "a JAX platform helper",
    ("utils/devices.py", "enable_compilation_cache"): "a JAX platform helper",
    ("utils/devices.py", "force_cpu_devices"): "a JAX platform helper",
    ("utils/devices.py", "forced_device_count"): "a JAX platform helper",
    ("utils/devices.py", "pin_cpu_platform"): "a JAX platform helper",
    ("ops/apply.py", "ApplyResult"): "the flat engine (not ported, by choice)",
    ("ops/apply.py", "apply_batch"): "the flat engine (not ported, by choice)",
    ("ops/dots.py", "merge_contexts"): "the flat engine (not ported, by choice)",
    ("ops/dots.py", "MergedContext"): "the flat engine (not ported, by choice)",
    ("models/__init__.py", "DotStore"): "the flat engine (not ported, by choice)",
    ("models/__init__.py", "FlatAWLWWMap"): "the flat engine (not ported, by choice)",
}

#: JAX modules with no counterpart file (``ROADMAP.md``, "Not ported, by choice")
NOT_PORTED = {
    "models/aw_lww_map.py",
    "models/state.py",
    "ops/hashtree.py",
    "ops/join.py",
    "ops/membership.py",
    "ops/read.py",
    "utils/jitcache.py",
    "utils/pyref.py",
}


def _names(path: Path, *, bound: bool) -> tuple[set, dict]:
    """``(top-level names, {class: member names})`` of a module. With
    ``bound`` every binding counts (imports too: a re-export is a name);
    without it only what the module defines or lists in ``__all__``."""
    tree = ast.parse(path.read_text())
    top: set = set()
    classes: dict = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            top.add(node.name)
            if isinstance(node, ast.ClassDef):
                members = set()
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        members.add(m.name)
                    elif isinstance(m, ast.Assign):
                        members |= {t.id for t in m.targets if isinstance(t, ast.Name)}
                classes[node.name] = members
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    top.add(t.id)
                    if t.id == "__all__":
                        top |= {e.value for e in node.value.elts}
                elif isinstance(t, ast.Tuple):
                    top |= {e.id for e in t.elts if isinstance(e, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            top.add(node.target.id)
        elif bound and isinstance(node, (ast.Import, ast.ImportFrom)):
            top |= {a.asname or a.name.split(".")[0] for a in node.names}
    return top, classes


def _excluded(rel: str, name: str) -> bool:
    return any(
        mod == rel and (name == pat or (pat.endswith("*") and name.startswith(pat[:-1])))
        for mod, pat in EXCLUDED
    )


def _jax_modules() -> list:
    return sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


def _counterpart(rel: str) -> Path:
    return PORT / RENAMED.get(rel, rel)


PAIRED = [rel for rel in _jax_modules() if _counterpart(rel).exists()]


@pytest.mark.parametrize("rel", PAIRED)
def test_every_public_name_has_a_port(rel):
    jax_top, jax_classes = _names(JAX / rel, bound=False)
    port_top, port_classes = _names(_counterpart(rel), bound=True)
    missing = sorted(
        n for n in jax_top - port_top if not n.startswith("_") and not _excluded(rel, n)
    )
    assert not missing, f"{rel}: the port lacks {missing}"
    for cls, members in sorted(jax_classes.items()):
        if cls not in port_classes:
            continue
        lacking = sorted(m for m in members - port_classes[cls] if not m.startswith("_"))
        assert not lacking, f"{rel}: {cls} lacks {lacking}"


def test_every_exclusion_names_a_real_jax_name():
    """A stale exclusion would hide nothing but still read as a reason."""
    for (rel, pat), reason in EXCLUDED.items():
        assert reason
        top, _ = _names(JAX / rel, bound=False)
        assert any(n == pat or (pat.endswith("*") and n.startswith(pat[:-1])) for n in top), (rel, pat)


def test_modules_without_a_port_are_the_roadmaps_by_choice_set():
    no_file = {rel for rel in _jax_modules() if not _counterpart(rel).exists()}
    assert no_file == NOT_PORTED
    text = (ROOT / "ROADMAP.md").read_text()
    # the bullet list right under the heading, up to the first blank line
    section = text.split("**Not ported, by choice:**", 1)[1].strip().split("\n\n", 1)[0]
    listed = set(re.findall(r"`((?:models|ops|utils|runtime|parallel|native)/[a-z_]+\.py)`", section))
    assert listed == NOT_PORTED


def test_renamed_counterparts_exist():
    for rel, port_rel in RENAMED.items():
        assert (JAX / rel).exists() and (PORT / port_rel).exists()
