"""Device topology and the 1-D replica mesh — the PyTorch port of the
mesh helpers of ``delta_crdt_ex_tpu/utils/devices.py`` (``detected_topology``,
``mesh_shard_count``, ``fleet_mesh``) and of
``delta_crdt_ex_tpu/parallel/mesh_gossip.py`` (``make_mesh``,
``replica_sharding``, ``place_states``).

The JAX package runs its mesh single-controller: one process,
``Mesh(devices, ("replicas",))``, ``shard_map`` over a block-split
leading lane axis, ``lax.ppermute`` the only cross-shard movement. The
port keeps that model without a multi-process ``DeviceMesh``:

- a :class:`Mesh` is a 1-D tuple of ``torch.device``\\ s under the axis
  name ``"replicas"``, ``shards = len(devices)``, a power of two;
- shard ``s`` holds lanes ``[s·k, (s+1)·k)`` of a stacked state on
  ``devices[s]`` (``k = lanes / shards``, the ``P("replicas")`` block
  split) — a :class:`Sharded` value, one block per shard;
- :func:`rotate` moves shard ``i``'s block to shard ``(i + shift) % S``
  as ``Tensor.to(dst, copy=True, non_blocking=True)`` — a peer copy
  between cards, a device-local copy on one card (always a copy: the
  receiver owns fresh buffers, as ``ppermute``'s are).

A mesh built from an explicit device list may repeat a device (torch
has one CPU device, and a one-card host has one GPU), which is how the
CPU tests and a one-card run exercise 1-8 shards; ``fleet_mesh`` over
the detected devices refuses more shards than devices, as the JAX one
does. A mesh may also span ``torch.distributed`` ranks
(``ranks=``, one per shard): each process then holds only its own
shards' blocks, and a rotation hop between processes is a
``dist.batch_isend_irecv`` pair (gloo on the CPU, NCCL between cards).
Single-process code never needs ``torch.distributed`` initialised.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

#: the mesh axis name (the JAX package's ``parallel/mesh_gossip.AXIS``)
AXIS = "replicas"


def _process_rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _process_count() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class Mesh:
    """A 1-D replica mesh: ``devices[s]`` holds shard ``s``; ``ranks[s]``
    is the ``torch.distributed`` rank owning it (all this process's when
    not given)."""

    __slots__ = ("devices", "ranks", "rank", "axis_names")

    def __init__(self, devices, ranks=None, axis_names=(AXIS,)) -> None:
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.rank = _process_rank()
        self.ranks = tuple(int(r) for r in ranks) if ranks is not None else (self.rank,) * len(self.devices)
        if len(self.ranks) != len(self.devices):
            raise ValueError(f"{len(self.ranks)} ranks for {len(self.devices)} mesh devices")
        self.axis_names = tuple(axis_names)

    @property
    def shards(self) -> int:
        return len(self.devices)

    def local(self, s: int) -> bool:
        """Whether shard ``s`` lives in this process."""
        return self.ranks[s] == self.rank

    @property
    def spans_processes(self) -> bool:
        return any(r != self.rank for r in self.ranks)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, ranks={list(self.ranks)}, axis_names={self.axis_names})"


def on_device(device: torch.device):
    """Run a shard's work with its card current (a no-op on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# port pytrees: tensors inside NamedTuples, store dataclasses, lists, dicts


def tree_map(fn, tree, leaves=(torch.Tensor,)):
    """``fn`` on every leaf of type ``leaves`` (tensors by default) of a
    tree of NamedTuples (type kept), store dataclasses (static fields
    kept), lists, tuples and dicts; other leaves pass through."""
    if isinstance(tree, leaves):
        return fn(tree)
    if isinstance(tree, Sharded):
        raise TypeError("tree_map over a Sharded value: map its blocks instead")
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: tree_map(fn, getattr(tree, f.name), leaves) for f in dataclasses.fields(tree)}
        )
    if isinstance(tree, tuple):
        out = [tree_map(fn, v, leaves) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    if isinstance(tree, list):
        return [tree_map(fn, v, leaves) for v in tree]
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, leaves) for k, v in tree.items()}
    return tree


def _tree_zip(fn, trees: list):
    """``fn(list of tensors)`` over matching leaves of equally shaped
    trees; non-tensor leaves must agree and pass through."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(trees)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(
            first, **{f.name: _tree_zip(fn, [getattr(t, f.name) for t in trees]) for f in dataclasses.fields(first)}
        )
    if isinstance(first, tuple):
        out = [_tree_zip(fn, list(vs)) for vs in zip(*trees)]
        return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
    if isinstance(first, list):
        return [_tree_zip(fn, list(vs)) for vs in zip(*trees)]
    if isinstance(first, dict):
        return {k: _tree_zip(fn, [t[k] for t in trees]) for k in first}
    return first


def _tensor_leaves(tree) -> list:
    found: list = []
    tree_map(lambda t: found.append(t) or t, tree)
    return found


# ---------------------------------------------------------------------------
# the sharded value


class Sharded:
    """A value whose leading lane axis is block-split over a mesh: one
    block per shard, each on its shard's device (``None`` for a shard of
    another process). Blocks are tensors or trees of them (a stacked
    store, a merge result); attribute access reaches into the blocks —
    ``res.state`` of a sharded merge result is the sharded state, and a
    store property that is the same int on every block (``num_buckets``,
    ``probe_window``) reads as that int."""

    __slots__ = ("mesh", "blocks")

    def __init__(self, mesh: Mesh, blocks) -> None:
        object.__setattr__(self, "mesh", mesh)
        object.__setattr__(self, "blocks", list(blocks))
        if len(self.blocks) != mesh.shards:
            raise ValueError(f"{len(self.blocks)} blocks for a {mesh.shards}-shard mesh")

    def _local(self) -> list:
        return [b for b in self.blocks if b is not None]

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        vals = [None if b is None else getattr(b, name) for b in self.blocks]
        present = [v for v in vals if v is not None]
        if not present:
            raise AttributeError(name)
        if callable(present[0]) and not isinstance(present[0], torch.Tensor):
            raise AttributeError(f"Sharded has no method {name!r}; use map()")
        if isinstance(present[0], (torch.Tensor, tuple, list, dict)) or dataclasses.is_dataclass(present[0]):
            return Sharded(self.mesh, vals)
        if any(v != present[0] for v in present):
            raise AttributeError(f"{name!r} differs between shards: {present}")
        return present[0]

    def __setattr__(self, name, value):
        raise AttributeError("Sharded values are immutable")

    def map(self, fn) -> "Sharded":
        """``fn`` on every local block (a per-shard operation)."""
        return Sharded(self.mesh, [None if b is None else fn(b) for b in self.blocks])

    # -- tensor blocks: global shape and lane indexing --------------------

    @property
    def lanes_per_shard(self) -> int:
        return int(_tensor_leaves(self._local()[0])[0].shape[0])

    @property
    def shape(self) -> torch.Size:
        b = self._local()[0]
        if not isinstance(b, torch.Tensor):
            raise AttributeError("shape of a Sharded tree: read a field first")
        return torch.Size((b.shape[0] * self.mesh.shards,) + tuple(b.shape[1:]))

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for b in self._local() for t in _tensor_leaves(b))

    def _where(self, lane: int) -> tuple:
        k = self.lanes_per_shard
        n = k * self.mesh.shards
        if not -n <= lane < n:
            raise IndexError(f"lane {lane} out of range for {n} lanes")
        s, i = divmod(lane % n, k)
        if self.blocks[s] is None:
            raise IndexError(f"lane {lane} lives on shard {s} of rank {self.mesh.ranks[s]}")
        return s, i

    def __getitem__(self, idx):
        """Lane ``idx`` (an int, or a tuple whose first item is the lane)
        of a tensor block, on its shard's device."""
        rest: tuple = ()
        if isinstance(idx, tuple):
            idx, rest = idx[0], idx[1:]
        if not isinstance(idx, int):
            raise TypeError("a Sharded value is indexed by lane (an int) first")
        s, i = self._where(idx)
        return self.blocks[s][(i,) + rest]

    def lane(self, lane: int):
        """Lane ``lane`` of every tensor leaf of the blocks' tree."""
        s, i = self._where(lane)
        return tree_map(lambda t: t[i], self.blocks[s])

    def gather(self, device=None):
        """The whole value as one tree on ``device`` (default: the first
        shard's device): every leaf's blocks concatenated in shard
        order. Needs every block in this process."""
        if any(b is None for b in self.blocks):
            raise ValueError("gather of a process-spanning value: use process_allgather")
        dev = self.mesh.devices[0] if device is None else torch.device(device)
        return _tree_zip(lambda ts: torch.cat([t.to(dev) for t in ts]), self.blocks)

    def __repr__(self) -> str:
        return f"Sharded({self.mesh!r}, {len(self._local())} local blocks)"


def split(mesh: Mesh, value, copy: bool = False):
    """``value`` block-split over ``mesh`` on its leading (lane) axis:
    a :class:`Sharded` value passes as it is; a tree of full tensors is
    cut into ``shards`` equal lane blocks, each moved to its shard's
    device (only this process's shards are kept). ``copy=True`` makes
    every block its own buffer even where the device does not change."""
    if isinstance(value, Sharded):
        if value.mesh is not mesh and (value.mesh.devices != mesh.devices or value.mesh.ranks != mesh.ranks):
            raise ValueError(f"value is sharded over {value.mesh!r}, not {mesh!r}")
        return value
    leaves = _tensor_leaves(value)
    if not leaves:
        raise ValueError("nothing to shard: the value holds no tensor")
    n = int(leaves[0].shape[0])
    S = mesh.shards
    if n % S:
        raise ValueError(f"{n} lanes do not split evenly over {S} shards")
    k = n // S

    def block(s):
        if not mesh.local(s):
            return None
        dev = mesh.devices[s]
        return tree_map(lambda t: t[s * k:(s + 1) * k].to(dev, copy=copy), value)

    return Sharded(mesh, [block(s) for s in range(S)])


def rotate(mesh: Mesh, shift: int, value):
    """The ``ppermute`` of a rotation by ``shift``: shard ``i``'s block
    becomes shard ``(i + shift) % S``'s, always as a fresh copy on the
    destination's device (a receiver's write can never reach the
    sender's buffer, whatever the devices). Hops between processes of a
    process-spanning mesh are one ``dist.batch_isend_irecv`` batch."""
    value = split(mesh, value)
    S = mesh.shards
    out: list = [None] * S
    p2p: list = []
    recv: dict = {}
    for i in range(S):
        j = (i + shift) % S
        if mesh.local(i) and mesh.local(j):
            out[j] = tree_map(
                lambda t, d=mesh.devices[j]: t.to(d, copy=True, non_blocking=True), value.blocks[i]
            )
        elif mesh.local(i) or mesh.local(j):
            p2p.append((i, j))
    if p2p:
        dist = torch.distributed
        template = value._local()[0]
        ops = []
        for i, j in p2p:
            if mesh.local(i):
                for t in _tensor_leaves(value.blocks[i]):
                    ops.append(dist.P2POp(dist.isend, t.contiguous(), mesh.ranks[j], tag=j))
            else:
                bufs = tree_map(lambda t, d=mesh.devices[j]: torch.empty_like(t, device=d), template)
                recv[j] = bufs
                for t in _tensor_leaves(bufs):
                    ops.append(dist.P2POp(dist.irecv, t, mesh.ranks[i], tag=j))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        for j, bufs in recv.items():
            out[j] = bufs
    return Sharded(mesh, out)


def process_allgather(value):
    """Every shard's block of ``value`` in every process, concatenated
    in shard order on the host (the port's
    ``multihost_utils.process_allgather(tiled=True)``, for
    ``gossip_delta_drive(gather=...)`` over a process-spanning mesh).
    A single-process value is gathered without collectives."""
    if not isinstance(value, Sharded):
        raise TypeError("process_allgather takes a Sharded value")
    mesh = value.mesh
    if not mesh.spans_processes:
        return value.gather("cpu")
    dist = torch.distributed
    # NCCL moves card buffers only; gloo (the CPU tests) host ones
    wire = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    blocks: list = []
    for s in range(mesh.shards):
        b = value.blocks[s]
        if b is None:
            b = torch.empty_like(value._local()[0], device=wire)
        else:
            b = b.detach().to(wire).contiguous()
        dist.broadcast(b, src=mesh.ranks[s])
        blocks.append(b.cpu())
    return torch.cat(blocks)


# ---------------------------------------------------------------------------
# topology and mesh construction


def local_devices() -> list:
    """This process's devices: every visible card, else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def detected_topology() -> dict:
    """The detected device shape in the JAX package's vocabulary:
    platform (``"gpu"`` with CUDA, else ``"cpu"``), global and local
    device counts and the process count (``torch.distributed``'s world
    size, 1 when it is not initialised; the global count assumes every
    process has this one's devices)."""
    local = len(local_devices())
    procs = _process_count()
    return {
        "platform": "gpu" if torch.cuda.is_available() else "cpu",
        "global_devices": local * procs,
        "local_devices": local,
        "processes": procs,
    }


def mesh_shard_count(n_devices: "int | None" = None) -> int:
    """Largest power-of-two shard count the detected (or given) device
    count supports — the default width of :func:`fleet_mesh`."""
    if n_devices is None:
        n_devices = len(local_devices())
    if n_devices < 1:
        raise ValueError("no devices detected")
    return 1 << (int(n_devices).bit_length() - 1)


def fleet_mesh(shards: "int | None" = None, devices=None) -> Mesh:
    """A 1-D mesh over ``devices[:shards]`` for ``Fleet(mesh=...)`` /
    ``start_fleet(..., mesh=...)``. ``devices`` defaults to this
    process's devices; ``shards`` to the largest power of two they
    support. Non-pow2 counts raise, and so do more shards than devices:
    to put several shards on one device, list it that many times."""
    devices = local_devices() if devices is None else list(devices)
    if shards is None:
        shards = mesh_shard_count(len(devices))
    shards = int(shards)
    if shards < 1 or shards & (shards - 1):
        raise ValueError(f"mesh shard count must be a power of two: {shards}")
    if shards > len(devices):
        raise ValueError(
            f"{shards} shards requested but only {len(devices)} device(s) detected "
            "(list a device several times to put several shards on it)"
        )
    return Mesh(devices[:shards])


def make_mesh(devices=None, ranks=None) -> Mesh:
    """A mesh over ``devices`` (default: this process's devices), one
    shard each; ``ranks`` gives each shard's process for a mesh that
    spans ``torch.distributed`` ranks."""
    return Mesh(local_devices() if devices is None else list(devices), ranks=ranks)


class ReplicaSharding:
    """Leading axis = replica lanes, block-split over the mesh (the
    ``P("replicas")`` sharding): :meth:`put` places a tree of full
    stacked tensors."""

    __slots__ = ("mesh",)

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh

    def put(self, value):
        """A tree of full stacked tensors as one :class:`Sharded` value;
        a dict of them as a dict of sharded columns."""
        if isinstance(value, dict):
            return {k: self.put(v) for k, v in value.items()}
        return split(self.mesh, value, copy=True)


def replica_sharding(mesh: Mesh) -> ReplicaSharding:
    return ReplicaSharding(mesh)


def place_states(states: list, mesh: Mesh) -> Sharded:
    """Stack replica states and block-split them over the mesh, one
    lane block per shard (only this process's shards are kept)."""
    from delta_crdt_ex_tpu_torch.runtime.transition import stack_states

    return replica_sharding(mesh).put(stack_states(states))
