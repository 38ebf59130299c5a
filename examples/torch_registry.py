"""A Horde.Registry-style distributed process registry on the map CRDT,
with the PyTorch port — the port's counterpart of
``examples/registry.py``.

The reference library's flagship consumers are Horde.Registry /
Horde.Supervisor (``lib/delta_crdt.ex:13``): a cluster-wide name →
process mapping replicated through the CRDT, with last-write-wins
conflict resolution on double-registration and cleanup when a node dies:

- each "node" owns one replica of a shared ``AWLWWMap`` on the hash
  store, so a lookup (``read_keys``) runs the probe-window kernel on the
  card;
- ``register(name, node, pid)`` is an ``add``; a bulk of names goes in
  through ``mutate_batch``;
- concurrent double-registration resolves by LWW: every node converges
  to the same winner (no split brain);
- a node crashes, and a survivor removes the dead node's registrations
  (the Horde cleanup pattern).

Run: python examples/torch_registry.py [--device cpu] [--names N]
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

NODES = ("node-a", "node-b", "node-c")


def wait_until(cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise SystemExit(f"timed out waiting for {what}")
        time.sleep(0.02)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    ap.add_argument("--names", type=int, default=1024, help="names registered in bulk, a third on each node")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")

    nodes = {
        node: dc.start_link(
            dc.AWLWWMap, store="hash", name=f"registry-{node}", sync_interval=0.02,
            capacity=256, tree_depth=6, device=args.device,
        )
        for node in NODES
    }
    for me in nodes.values():
        me.set_neighbours([r for r in nodes.values() if r is not me])

    def register(node, name, pid):
        dc.mutate(nodes[node], "add", [name, (node, pid)])

    def whereis(node, name):
        return dc.read_keys(nodes[node], [name]).get(name)

    # -- normal registration propagates everywhere ----------------------
    register("node-a", "user-service", 101)
    register("node-b", "mail-service", 202)
    wait_until(
        lambda: all(
            whereis(n, "user-service") == ("node-a", 101) and whereis(n, "mail-service") == ("node-b", 202)
            for n in nodes
        ),
        "registrations propagate",
    )
    print("registered: user-service@node-a, mail-service@node-b — visible cluster-wide")

    # -- a bulk of names, a third from each node ------------------------
    owner = {f"svc-{i}": NODES[i % 3] for i in range(args.names)}
    for node in NODES:
        dc.mutate_batch(nodes[node], "add", [[name, (node, i)] for i, (name, o) in enumerate(owner.items()) if o == node])
    names = list(owner)
    wait_until(
        lambda: all(len(dc.read_keys(nodes[n], names)) == len(names) for n in nodes), "bulk registrations propagate"
    )
    print(f"{len(names)} names registered in bulk, every lookup answered on every node")

    # -- concurrent double-registration: LWW, no split brain -------------
    register("node-a", "cache", 111)
    register("node-c", "cache", 333)
    wait_until(lambda: len({str(whereis(n, "cache")) for n in nodes}) == 1, "conflict converges")
    winner = whereis("node-a", "cache")
    assert all(whereis(n, "cache") == winner for n in nodes)
    print(f"double-registration of 'cache' resolved cluster-wide to {winner}")

    # -- node death: survivors clean up its names -------------------------
    dead = "node-b"
    dead_names = [k for k, v in dc.read(nodes["node-a"]).items() if v[0] == dead]
    nodes[dead].crash()  # no goodbye sync, no flush: the node just dies
    del nodes[dead]
    dc.mutate_batch(nodes["node-a"], "remove", [[name] for name in dead_names])  # the janitor step
    wait_until(lambda: all(whereis(n, "mail-service") is None for n in nodes), "dead node's names cleaned up")
    assert whereis("node-c", "user-service") == ("node-a", 101)  # the others stay
    wait_until(lambda: dc.read(nodes["node-a"]) == dc.read(nodes["node-c"]), "survivors agree")
    assert not any(v[0] == dead for v in dc.read(nodes["node-c"]).values())
    print(f"{dead} died; its {len(dead_names)} registrations are gone, everything else intact")

    for r in nodes.values():
        r.stop()
    print(f"registry demo on {args.device}: ok")


if __name__ == "__main__":
    main()
