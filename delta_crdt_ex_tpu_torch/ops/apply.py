"""Mutation op codes (``delta_crdt_ex_tpu/ops/apply.py:34-37``).

Op codes: 0 = padding, 1 = add, 2 = remove, 3 = clear.
"""

OP_PAD = 0
OP_ADD = 1
OP_REMOVE = 2
OP_CLEAR = 3
