"""Reading one replica out of the program's neighbour stack, for the
comparison (:class:`crdtbench.reference.compare.Lane`).

The program's stores are dataclasses of tensors with a leading lane
axis; a packed stack is read through the program's own ``unpack`` (its
word layout is the program's business). Nothing here computes what the
lane should hold.

``control="ts32"`` is the control of the comparison: the lane's
timestamps cut to their low 32 bits, what a map that kept its
microsecond timestamps in 32 bits would hold. It breaks the
configuration's guarantee of LWW by 64-bit timestamps, and the
comparison has to see it.
"""

from __future__ import annotations

import dataclasses

import torch

from crdtbench.reference.compare import M32, Lane

CONTROLS = ("ts32",)


def lane(stack, i: int, control: str | None = None) -> Lane:
    from delta_crdt_ex_tpu_torch.ops.packed import PackedStore, unpack

    one = dataclasses.replace(stack, **{f.name: getattr(stack, f.name)[i] for f in dataclasses.fields(stack)})
    if isinstance(one, PackedStore):
        one = unpack(one)
    a = one.alive
    slots = one.node.to(torch.int64).clamp(0, one.ctx_gid.shape[-1] - 1)
    ts = one.ts[a]
    if control == "ts32":
        ts = ts & M32
    elif control is not None:
        raise ValueError(f"unknown control {control!r}; known: {CONTROLS}")
    return Lane(
        key=one.key[a],
        gid=one.ctx_gid[slots[a]],
        ctr=one.ctr[a],
        ts=ts,
        valh=one.valh[a],
        ctx_gid=one.ctx_gid,
        ctx_max=one.ctx_max,
        leaf=one.leaf,
    )


def count_off(judge, stack, control: str | None = None) -> dict:
    """``{"entries_off", "context_off", "leaf_off"}`` summed over every
    lane of ``stack``, each lane read and judged in turn."""
    off = {"entries_off": 0, "context_off": 0, "leaf_off": 0}
    for i in range(int(stack.ctx_gid.shape[0])):
        ln = lane(stack, i, control)
        off["entries_off"] += judge.entries_off(ln)
        off["context_off"] += judge.context_off(ln)
        off["leaf_off"] += judge.leaf_off(ln)
    return off
