from delta_crdt_ex_tpu_torch.parallel.batched_sync import (
    fanout_merge,
    fanout_merge_into,
    fanout_merge_packed,
    pack_states,
    ring_gossip_round,
    stack_states,
    unstack_states,
)
from delta_crdt_ex_tpu_torch.parallel.mesh_gossip import (
    AXIS,
    gossip_delta_drive,
    gossip_delta_step,
    gossip_train_step,
    make_mesh,
    place_states,
    replica_sharding,
    restore_mesh,
    snapshot_mesh,
)

__all__ = [
    "AXIS",
    "fanout_merge",
    "fanout_merge_into",
    "fanout_merge_packed",
    "gossip_delta_drive",
    "gossip_delta_step",
    "gossip_train_step",
    "make_mesh",
    "pack_states",
    "place_states",
    "replica_sharding",
    "restore_mesh",
    "ring_gossip_round",
    "snapshot_mesh",
    "stack_states",
    "unstack_states",
]
