from delta_crdt_ex_tpu_torch.parallel.batched_sync import (
    fanout_merge,
    fanout_merge_into,
    fanout_merge_packed,
    pack_states,
    ring_gossip_round,
    stack_states,
    unstack_states,
)

__all__ = [
    "fanout_merge",
    "fanout_merge_into",
    "fanout_merge_packed",
    "pack_states",
    "ring_gossip_round",
    "stack_states",
    "unstack_states",
]
