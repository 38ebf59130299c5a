"""PyTorch port vs JAX package: the transfer ledger's helpers
(``tests/test_transfers.py:32-113``).

Registration is idempotent from one call site and raises from another;
labels must be non-empty strings; ``get``/``put``/``note`` advance
(count, bytes); ``delta`` omits sites that did not move; the function
forms ``audited_get``/``audited_put`` count through their site;
``counts`` and the ``/varz`` envelope read the ledger. Each case runs on
both ledgers. They differ where ``ROADMAP.md`` §3.2 records: the JAX
``get`` counts a crossing for a tree of host arrays, the port's none.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from delta_crdt_ex_tpu.utils import transfers as j_transfers
from delta_crdt_ex_tpu_torch.utils import transfers as t_transfers
from tests.test_torch_lattice import jax_compiles_released  # noqa: F401 (autouse)

LEDGERS = {"jax": j_transfers, "port": t_transfers}


@pytest.fixture(params=sorted(LEDGERS))
def ledger(request):
    return LEDGERS[request.param]


def test_register_same_origin_idempotent(ledger):
    handles = [ledger.register("testonly.torch_reload_probe") for _ in range(2)]
    assert handles[0] is handles[1]


def test_register_collision_from_different_call_site_raises(ledger):
    ledger.register("testonly.torch_collision_probe")
    with pytest.raises(ValueError, match="already registered"):
        ledger.register("testonly.torch_collision_probe")


def test_register_rejects_non_string_labels(ledger):
    for bad in ("", None):
        with pytest.raises(ValueError, match="non-empty str"):
            ledger.register(bad)


def test_site_accounting_and_delta_semantics():
    """The same get/put/note script on both ledgers gives the same
    deltas, and ``delta`` lists only the site that moved."""
    deltas = {}
    for pkg, ledger in LEDGERS.items():
        site = ledger.register("testonly.torch_accounting_probe")
        before = ledger.snapshot()
        a = np.arange(16, dtype=np.int64)  # 128 bytes
        back = site.get(site.put(a))
        assert np.array_equal(np.asarray(back), a)
        site.note(7, crossings=2)
        after = ledger.snapshot()
        d = ledger.delta(before, after)
        assert d == {"testonly.torch_accounting_probe": {"count": 4, "bytes": 263}}
        assert list(after) == sorted(after)
        assert ledger.counts() == {label: v["count"] for label, v in after.items()}
        deltas[pkg] = d
    assert deltas["port"] == deltas["jax"]


def test_tree_accounting_and_host_leaves():
    """A dict of device arrays is one crossing of its summed bytes on
    both ledgers; a dict of host arrays only is one crossing in JAX and
    none in the port (``ROADMAP.md`` §3.2)."""
    host = {"x": np.zeros(4, np.int64), "y": np.zeros(2, np.int64)}
    got = {}
    for pkg, ledger in LEDGERS.items():
        site = ledger.register("testonly.torch_tree_probe")
        device = site.put(host)
        pre = ledger.snapshot()
        site.get(device)
        on_device = ledger.delta(pre, ledger.snapshot())
        pre = ledger.snapshot()
        site.get(host)
        got[pkg] = (on_device, ledger.delta(pre, ledger.snapshot()))
    assert got["jax"][0] == got["port"][0] == {"testonly.torch_tree_probe": {"count": 1, "bytes": 48}}
    assert got["jax"][1] == {"testonly.torch_tree_probe": {"count": 1, "bytes": 48}}
    assert got["port"][1] == {}


def test_audited_helper_forms_count_through_the_site():
    for pkg, ledger in LEDGERS.items():
        site = ledger.register("testonly.torch_helper_probe")
        pre = ledger.snapshot()
        dev = ledger.audited_put(np.ones(4, np.float32), site)
        back = ledger.audited_get(dev, site)
        assert np.array_equal(np.asarray(back), np.ones(4, np.float32))
        assert ledger.delta(pre, ledger.snapshot()) == {"testonly.torch_helper_probe": {"count": 2, "bytes": 32}}
        if pkg == "port":
            assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"  # no device asked: it stays


def test_varz_envelope_shape(ledger):
    ledger.register("testonly.torch_varz_probe")
    v = ledger.varz()
    assert v["kind"] == "transfers"
    assert v["stats"]["testonly.torch_varz_probe"] == {"count": 0, "bytes": 0}
