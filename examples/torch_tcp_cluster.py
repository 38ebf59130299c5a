"""A two-"node" cluster of PyTorch-port replicas over real sockets, with
persistence and a diff feed — the port's counterpart of
``examples/tcp_cluster.py``: ``{name, node}``-style remote addressing,
the ``on_diffs`` change feed, ``FileStorage`` crash recovery.

Run: python examples/torch_tcp_cluster.py [--device cpu]
(the replicas keep their state on "cuda" unless ``--device cpu`` is
given). A JAX replica on the JAX package's ``TcpTransport`` can be a
neighbour of either node: both packages speak one wire.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import delta_crdt_ex_tpu_torch as dc  # noqa: E402


def wait_until(pred, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        time.sleep(0.02)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    device = ap.parse_args().device

    node_a, node_b = dc.TcpTransport(), dc.TcpTransport()
    state_dir = tempfile.mkdtemp(prefix="crdt-demo-")
    changes = []
    a = dc.start_link(
        dc.AWLWWMap, transport=node_a, name="users", sync_interval=0.02,
        storage_module=dc.FileStorage(state_dir), device=device,
    )
    b = dc.start_link(
        dc.AWLWWMap, transport=node_b, name="users", sync_interval=0.02,
        on_diffs=changes.append, device=device,
    )
    # one-way edges, set symmetrically — (name, (host, port)) addressing
    a.set_neighbours([node_b.remote_addr("users")])
    b.set_neighbours([node_a.remote_addr("users")])

    dc.mutate(a, "add", ["alice", {"role": "admin"}])
    dc.mutate(a, "add", ["bob", {"role": "dev"}])
    # a remove only kills OBSERVED entries (observed-remove semantics):
    # wait until node B has seen bob before removing him
    wait_until(lambda: dc.read(b).get("bob") is not None, "bob reaching node B")
    dc.mutate(b, "remove", ["bob"])
    want = {"alice": {"role": "admin"}}
    wait_until(lambda: dc.read(a) == dc.read(b) == want, "remove propagating")
    print("node A:", dc.read(a))
    print("node B:", dc.read(b))
    print("diff feed at B:", changes)

    # crash node A (no clean stop) and rehydrate from disk on a new
    # endpoint: same node id, same state, sync continues
    a.crash()
    node_a.close()
    node_a2 = dc.TcpTransport()
    a2 = dc.start_link(
        dc.AWLWWMap, transport=node_a2, name="users", sync_interval=0.02,
        storage_module=dc.FileStorage(state_dir), device=device,
    )
    assert dc.read(a2) == want, "rehydrated state differs"
    a2.set_neighbours([node_b.remote_addr("users")])
    b.set_neighbours([node_a2.remote_addr("users")])
    dc.mutate(a2, "add", ["carol", {"role": "ops"}])
    wait_until(lambda: dc.read(b).get("carol") is not None, "post-rehydrate sync")
    print("after crash+rehydrate, node B:", dc.read(b))
    print("wire, node B:", node_b.transport_stats())
    for r in (a2, b):
        r.stop()
    node_a2.close()
    node_b.close()


if __name__ == "__main__":
    main()
