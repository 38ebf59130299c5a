"""YCSB core workload generation (Cooper et al., SoCC 2010;
``core/src/main/java/site/ycsb`` in github.com/brianfrankcooper/YCSB),
in host numpy, drawn from the run's ``--seed``. Nothing here imports
the program.

- Key names (``CoreWorkload.buildKeyName`` with ``insertorder=hashed``
  and ``zeropadding=1``): ``"user"`` followed by the decimal FNV-64 hash
  of the record number (``Utils.fnvhash64``: FNV-1 over the number's
  eight low-first octets, then ``Math.abs``).
- The request distribution ``zipfian``
  (``ScrambledZipfianGenerator``): a zipfian draw over
  ``ITEM_COUNT + 1`` items with the generator's precomputed
  ``ZETAN`` for the constant 0.99, scrambled by ``fnvhash64`` modulo
  ``recordcount + 1``; ``CoreWorkload.nextKeynum`` draws again while
  the number is past the last loaded record.
- Records (``fieldcount`` fields of ``fieldlength`` bytes): a tuple of
  byte strings of printable ASCII, as ``RandomByteIterator`` fills them.
- The operation chooser: a read with probability ``readproportion``,
  else an update (workload A has no scans and no inserts).
"""

from __future__ import annotations

import numpy as np

#: ``ScrambledZipfianGenerator.ITEM_COUNT`` and ``ZETAN`` (the zeta sum
#: of ITEM_COUNT items at the constant 0.99, precomputed by YCSB)
ITEM_COUNT = 10_000_000_000
ZETAN = 26.46902820178302
USED_ZIPFIAN_CONSTANT = 0.99

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(1099511628211)
_SIGN = np.uint64(1 << 63)


def fnvhash64(val) -> np.ndarray:
    """``Utils.fnvhash64`` on an array of non-negative numbers: uint64
    results equal to Java's ``long`` ones (non-negative after
    ``Math.abs``, save ``Long.MIN_VALUE``, which stays as it is)."""
    v = np.asarray(val, np.uint64).copy()
    h = np.full(v.shape, _FNV_OFFSET, np.uint64)
    with np.errstate(over="ignore"):
        for _ in range(8):
            h ^= v & np.uint64(0xFF)
            v >>= np.uint64(8)
            h *= _FNV_PRIME
        neg = (h & _SIGN) != 0
        h[neg] = (~h[neg]) + np.uint64(1)  # Math.abs of a negative long
    return h


def key_names(n: int) -> list:
    """The ``n`` loaded records' keys in record-number order."""
    return ["user" + str(h) for h in fnvhash64(np.arange(n, dtype=np.uint64)).tolist()]


class ScrambledZipfian:
    """``CoreWorkload``'s key chooser for ``requestdistribution=zipfian``
    over ``recordcount`` loaded records (no inserts expected, so the
    chooser's range is ``[0, recordcount]``)."""

    def __init__(self, recordcount: int, theta: float = USED_ZIPFIAN_CONSTANT):
        if theta != USED_ZIPFIAN_CONSTANT:
            raise ValueError("only the constant 0.99, whose zeta sum YCSB ships, is supported")
        self.recordcount = int(recordcount)
        self.itemcount = self.recordcount + 1
        self.items = ITEM_COUNT + 1  # ZipfianGenerator(0, ITEM_COUNT): max - min + 1
        self.theta = theta
        self.alpha = 1.0 / (1.0 - theta)
        self.zetan = ZETAN
        zeta2 = 1.0 + 0.5**theta
        self.eta = (1.0 - (2.0 / self.items) ** (1.0 - theta)) / (1.0 - zeta2 / self.zetan)

    def _zipf(self, u: np.ndarray) -> np.ndarray:
        uz = u * self.zetan
        ret = (self.items * np.power(self.eta * u - self.eta + 1.0, self.alpha)).astype(np.int64)
        ret = np.where(uz < 1.0 + 0.5**self.theta, 1, ret)
        return np.where(uz < 1.0, 0, ret)

    def draw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """``n`` record numbers in ``[0, recordcount)``."""
        out = np.empty(0, np.int64)
        while len(out) < n:
            z = self._zipf(rng.random(n - len(out)))
            keynum = (fnvhash64(z.astype(np.uint64)) % np.uint64(self.itemcount)).astype(np.int64)
            out = np.concatenate([out, keynum[keynum < self.recordcount]])
        return out


def records(rng: np.random.Generator, n: int, fieldcount: int, fieldlength: int) -> list:
    """``n`` records, each a tuple of ``fieldcount`` byte strings of
    ``fieldlength`` printable ASCII characters."""
    raw = (np.frombuffer(rng.bytes(n * fieldcount * fieldlength), np.uint8) % 95 + 32).tobytes()
    fields = [raw[i : i + fieldlength] for i in range(0, len(raw), fieldlength)]
    return [tuple(fields[i : i + fieldcount]) for i in range(0, len(fields), fieldcount)]


def operations(rng: np.random.Generator, n: int, readproportion: float) -> np.ndarray:
    """``n`` draws of the operation chooser: True for a read, False for
    an update."""
    return rng.random(n) < readproportion
