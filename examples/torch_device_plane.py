"""Replicas pinned to devices: the device data plane, with the PyTorch
port — the port's counterpart of ``examples/device_plane.py``.

A replica started with ``device=`` and an explicit device index
(``"cuda:0"``, ``"cuda:1"``, ...) is PINNED: its state lives on that
card, and anti-entropy slices for it are placed straight on its device
(a peer copy between cards, nothing at all on one card) while the
control plane — messages, payload dicts — stays on the host. A replica
on a bare ``"cuda"`` is not pinned and receives host-plane slices.

Run: python examples/torch_device_plane.py [--devices cuda:0,cuda:1]
(default: every visible card, one replica each, at least two replicas;
the replicas share the card when there is one. Without a card it
raises; it does not fall back to the CPU. ``--devices cpu:0,cpu:0``
runs it on the CPU.)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import delta_crdt_ex_tpu_torch as dc  # noqa: E402
from delta_crdt_ex_tpu_torch.utils import transfers  # noqa: E402


def wait_until(pred, what: str, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} not reached in {timeout} s")
        time.sleep(0.02)


def default_devices() -> list:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --devices cpu:0,cpu:0 to run on the CPU")
    n = torch.cuda.device_count()
    return [f"cuda:{i % n}" for i in range(max(n, 2))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", default="", help="comma-separated pinned devices, one replica each")
    args = ap.parse_args()
    devices = args.devices.split(",") if args.devices else default_devices()
    print(f"pinned devices: {devices}")

    replicas = [
        dc.start_link(dc.AWLWWMap, name=f"shard-{i}", sync_interval=0.02, capacity=256, tree_depth=6, device=d)
        for i, d in enumerate(devices)
    ]
    for r in replicas:
        dc.set_neighbours(r, [p for p in replicas if p is not r])

    # every replica writes its own keys; the device plane moves the slices
    for i, r in enumerate(replicas):
        for k in range(10):
            dc.mutate_async(r, "add", [f"d{i}/k{k}", (i, k)])

    want = {f"d{i}/k{k}": (i, k) for i in range(len(replicas)) for k in range(10)}
    wait_until(lambda: all(dc.read(r) == want for r in replicas), "all-device convergence", timeout=60)
    print(f"converged: {len(want)} keys on all {len(replicas)} replicas")
    placed = transfers.snapshot()["replica.slice_place"]["count"]
    for r in replicas:
        dev = r.state.leaf.device
        assert dev.type == r.pinned_device.type and (dev.index or 0) == (r.pinned_device.index or 0), (
            f"state strayed off its device: {dev}"
        )
        r.stop()
    assert placed > 0, "no slice rode the device plane"
    print(f"states stayed pinned; {placed} slices placed on the device plane — device plane ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
