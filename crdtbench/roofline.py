"""Byte counts and the card's peak: the least bytes a piece of work
needs, counted from its inputs and never from how the program does it.

Peak: one NVIDIA H100 SXM moves 3.35 TB/s between HBM and the SMs
(NVIDIA's data sheet) at its full 700 W power limit. A share of the
roofline is ``bytes / HBM_BYTES_PER_S / device seconds``; the run
records the card's power limit beside it (:func:`power_limit_w`),
since a card held below 700 W runs slower under load.
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np

HBM_BYTES_PER_S = 3.35e12

#: one map entry as its fields need it: key 8, timestamp 8, value hash
#: 4, counter 4, writer 4 (the digest is derived, so it is not counted)
ENTRY_BYTES = 28
#: a bucket's digest and one (bucket, writer) context cell
LEAF_BYTES = 4
CTX_BYTES = 4
#: a slice row's header: its bucket and its interval (lo, hi]
SLICE_ROW_BYTES = 12


def roots_bytes(n: int, L: int) -> int:
    """Digest-tree roots of n trees of L leaves: every leaf read once as
    its int64 word and every root written once."""
    return n * L * 8 + n * 8


def merge_bytes(lanes: int, before: np.ndarray, after: np.ndarray, slice_entries: int, slice_rows: int) -> int:
    """One delta slice merged into ``lanes`` replicas that hold the same
    map. A row whose content changes is read once as it was (``before``
    entries) and written once as it is (``after`` entries), with its
    digest and the slice writer's context cell; the slice is read once
    for all lanes."""
    per_lane = int((before + after).sum()) * ENTRY_BYTES + len(before) * 2 * (LEAF_BYTES + CTX_BYTES)
    return lanes * per_lane + slice_entries * ENTRY_BYTES + slice_rows * SLICE_ROW_BYTES


def share(nbytes: float, device_s: float) -> float | None:
    """Percent of the HBM roofline, or None where nothing was timed."""
    if not device_s or device_s <= 0:
        return None
    return nbytes / HBM_BYTES_PER_S / device_s * 100.0


def power_limit_w() -> str | None:
    """The card's power limit as ``nvidia-smi`` reports it."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    proc = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, timeout=30,
    )
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and proc.stdout.strip() else None
