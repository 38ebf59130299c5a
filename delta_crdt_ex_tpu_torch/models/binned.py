"""Capacity tiers shared by both dot stores — the part of
``delta_crdt_ex_tpu/models/binned.py`` the hash store needs. The
bucket-binned ``BinnedStore`` itself waits for the binned-store slice.
"""

from __future__ import annotations

#: uint32 all-ones (the ``amin``/``ldense`` sentinel), held as an int
#: because the port keeps uint32 columns as int64 values in [0, 2^32)
U32_MAX = 0xFFFFFFFF


def pow2_tier(n: int, floor: int = 1) -> int:
    """Round up to the power-of-two capacity tier."""
    c = floor
    while c < n:
        c *= 2
    return c


def pow4_tier(n: int, floor: int = 8) -> int:
    """Round up in ×4 steps — the WIRE tier (sync slices vary per
    message; tiering keeps the distinct shapes few and the wire bytes
    identical to the JAX package's)."""
    c = floor
    while c < n:
        c *= 4
    return c
