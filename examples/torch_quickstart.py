"""Two in-process replicas with the PyTorch port, the reference README
flow — the port's counterpart of ``examples/quickstart.py``.

Run: python examples/torch_quickstart.py [--device cpu]
(the replicas live on "cuda" unless ``--device cpu`` is given; without a
card the default raises, it does not fall back to the CPU).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import delta_crdt_ex_tpu_torch as dc  # noqa: E402


def wait_until(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise SystemExit(f"timed out waiting for {what}")
        time.sleep(0.02)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    device = ap.parse_args().device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")

    c1 = dc.start_link(dc.AWLWWMap, sync_interval=0.02, device=device)
    c2 = dc.start_link(dc.AWLWWMap, sync_interval=0.02, device=device)
    dc.set_neighbours(c1, [c2])
    dc.set_neighbours(c2, [c1])

    dc.mutate(c1, "add", ["CRDT", "is magic!"])
    wait_until(lambda: dc.read(c2) == {"CRDT": "is magic!"}, "replica 2 convergence")
    print(f"replica 2 sees: {dc.read(c2)} (state on {c2.state.device})")
    c1.stop()
    c2.stop()


if __name__ == "__main__":
    main()
