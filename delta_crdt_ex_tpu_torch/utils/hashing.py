"""Stable, replica-independent hashing of arbitrary Python terms.

The reference supports arbitrary Elixir terms as keys and values
(``aw_lww_map.ex:99-112``; ``README.md:39`` warns only about atom leakage).
On the device the kernels see only fixed-width hashes/ids, so the host must map
terms to integers **deterministically across replicas and hosts**: when two
replicas independently write the same key, the device-side key ids must
collide (same 64-bit hash → same bucket → same LWW group).

We canonically encode terms (type-tagged, recursive, order-normalised for
sets/dicts) and hash with BLAKE2b. Key ids are 64 bits (birthday bound ~2^32
keys — fine for the 1M-key north star); value hashes are 32 bits and are only
used for digest/equality hints, never for value identity (values travel by
dot, see ``runtime/replica.py``).

The PyTorch port's own copy of ``delta_crdt_ex_tpu/utils/hashing.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import pickle
import struct
from hashlib import blake2b

_TAG_NONE = b"\x00"
_TAG_TRUE = b"\x01"
_TAG_FALSE = b"\x02"
_TAG_INT = b"\x03"
_TAG_FLOAT = b"\x04"
_TAG_STR = b"\x05"
_TAG_BYTES = b"\x06"
_TAG_TUPLE = b"\x07"
_TAG_LIST = b"\x08"
_TAG_SET = b"\x09"
_TAG_DICT = b"\x0a"
_TAG_PICKLE = b"\x0b"


def canonical_bytes(term) -> bytes:
    """Deterministic byte encoding of a Python term.

    Containers are encoded recursively; sets and dicts are normalised by
    sorting their encoded elements so iteration order cannot leak in.
    Unknown types fall back to pickle (deterministic within one Python
    version for most types; documented caveat, mirroring the reference's
    own "arbitrary term" looseness).
    """
    t = type(term)
    if term is None:
        return _TAG_NONE
    if t is bool:
        return _TAG_TRUE if term else _TAG_FALSE
    if t is int:
        raw = term.to_bytes((term.bit_length() + 8) // 8 or 1, "big", signed=True)
        return _TAG_INT + struct.pack(">I", len(raw)) + raw
    if t is float:
        return _TAG_FLOAT + struct.pack(">d", term)
    if t is str:
        raw = term.encode("utf-8")
        return _TAG_STR + struct.pack(">I", len(raw)) + raw
    if t is bytes:
        return _TAG_BYTES + struct.pack(">I", len(term)) + term
    if t is tuple or t is list:
        tag = _TAG_TUPLE if t is tuple else _TAG_LIST
        parts = [canonical_bytes(x) for x in term]
        return tag + struct.pack(">I", len(parts)) + b"".join(parts)
    if t is set or t is frozenset:
        parts = sorted(canonical_bytes(x) for x in term)
        return _TAG_SET + struct.pack(">I", len(parts)) + b"".join(parts)
    if t is dict:
        parts = sorted(
            canonical_bytes(k) + canonical_bytes(v) for k, v in term.items()
        )
        return _TAG_DICT + struct.pack(">I", len(parts)) + b"".join(parts)
    raw = pickle.dumps(term, protocol=4)
    return _TAG_PICKLE + struct.pack(">I", len(raw)) + raw


def key_hash64(term) -> int:
    """64-bit key id. Replicas agree on this without coordination."""
    d = blake2b(canonical_bytes(term), digest_size=8).digest()
    h = int.from_bytes(d, "big")
    return h or 1  # 0 is reserved as the empty-slot sentinel


def value_hash32(term) -> int:
    """32-bit value digest (content hint for the sync index)."""
    d = blake2b(canonical_bytes(term), digest_size=4).digest()
    return int.from_bytes(d, "big")


def key_hash64_batch(terms: list):
    """uint64 key ids for a term batch, hashed in one call of the native
    batch hasher (:mod:`delta_crdt_ex_tpu_torch.native`; the JAX
    package's ``key_hash64_batch``), bit for bit
    :func:`key_hash64_batch_ref`."""
    from delta_crdt_ex_tpu_torch import native

    return native.hash64_batch([canonical_bytes(t) for t in terms])


def value_hash32_batch(terms: list):
    """uint32 value digests for a term batch (see key_hash64_batch)."""
    from delta_crdt_ex_tpu_torch import native

    return native.hash32_batch([canonical_bytes(t) for t in terms])


def key_hash64_batch_ref(terms: list):
    """The plain version of :func:`key_hash64_batch`: per-term
    :mod:`hashlib` BLAKE2b, the path the native hasher is held against."""
    import numpy as np

    out = np.empty(len(terms), np.uint64)
    for i, t in enumerate(terms):
        out[i] = key_hash64(t)
    return out


def value_hash32_batch_ref(terms: list):
    """The plain version of :func:`value_hash32_batch`."""
    import numpy as np

    out = np.empty(len(terms), np.uint32)
    for i, t in enumerate(terms):
        out[i] = value_hash32(t)
    return out
