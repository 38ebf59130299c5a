"""The digest mix, frozen: the entry hash, the per-bucket leaf digest and
the digest-tree fold, in plain numpy over uint64.

This is the map's published digest (the JAX package's
``ops/binned.py:70``/``:83``), copied here so that the benchmark's
reference never reads the program: an entry hash covers the writer's
global id, counter, timestamp, value hash and key; a bucket's leaf is
the wrapping uint32 sum of its alive entries' hashes; a root folds the
leaves pairwise with two murmur3 finalisers.
"""

from __future__ import annotations

import numpy as np

M32 = np.uint64(0xFFFFFFFF)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_P1 = np.uint64(0x85EBCA6B)
_P2 = np.uint64(0xC2B2AE35)
_GOLD = np.uint64(0x9E3779B9)


def _u64(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint64) if x.dtype == np.int64 else x.astype(np.uint64)


def mix64(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> np.uint64(30))) * _M1
    x = (x ^ (x >> np.uint64(27))) * _M2
    return x ^ (x >> np.uint64(31))


def mix32(x: np.ndarray) -> np.ndarray:
    x = ((x ^ (x >> np.uint64(16))) * _P1) & M32
    x = ((x ^ (x >> np.uint64(13))) * _P2) & M32
    return x ^ (x >> np.uint64(16))


def entry_hash(key, gid, ctr, ts, valh) -> np.ndarray:
    """uint64 arrays of uint32 content hashes (``ts`` may be int64)."""
    key, gid, ctr, ts, valh = (_u64(a) for a in (key, gid, ctr, ts, valh))
    with np.errstate(over="ignore"):
        h = mix64(key ^ mix64(gid ^ ctr) ^ mix64(ts ^ (valh << np.uint64(32))))
    return (h ^ (h >> np.uint64(32))) & M32


def leaves(num_buckets: int, bucket: np.ndarray, ehash: np.ndarray) -> np.ndarray:
    """uint64[L]: the wrapping uint32 sum of each bucket's hashes."""
    out = np.zeros(num_buckets, np.uint64)
    np.add.at(out, bucket, ehash)
    return out & M32


def root(leaf: np.ndarray) -> int:
    """The digest-tree root of a power-of-two leaf array."""
    cur = _u64(leaf) & M32
    with np.errstate(over="ignore"):
        while len(cur) > 1:
            pair = cur.reshape(-1, 2)
            left = mix32(pair[:, 0] ^ _P1)
            right = mix32(pair[:, 1] ^ _P2)
            cur = (left + (right << np.uint64(1)) + _GOLD) & M32
    return int(cur[0])
