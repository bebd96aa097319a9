"""Atomic, CRC-verified npz snapshot IO shared by the replay implementations.

A snapshot exists to survive kills (resume support), so the write itself
must survive kills: np.savez straight onto the destination truncates the
previous good snapshot before the new one is complete, and a SIGKILL
mid-write leaves nothing restorable.  Writes here go to a temp file in the
same directory followed by os.replace (atomic on POSIX), so the destination
always holds either the old snapshot or the new one — never a torn file.

Atomicity protects against OUR kills; it cannot protect against a torn
write below the rename (network FS replaying a partial flush, disk
corruption, a copy truncated in flight).  Every snapshot therefore carries
a CRC32 over its payload arrays (``__crc32__`` entry), verified EAGERLY at
``load()`` — zipfile's per-entry CRCs only fire lazily at array access,
which for a replay restore would mean dying mid-restore with the buffer
half-overwritten.  A failed check raises ``SnapshotCorrupt``, which is part
of ``MISSING``: restore paths treat a corrupt snapshot exactly like an
absent one (cold replay) instead of crashing the run.
"""

from __future__ import annotations

import os
import zipfile
import zlib

import numpy as np

from rainbow_iqn_apex_tpu_torch.utils import faults


class SnapshotCorrupt(Exception):
    """Snapshot payload does not match its recorded CRC32."""


# Exceptions that mean "no usable snapshot here" (missing, torn file from a
# kill, or payload corruption caught by the CRC), as opposed to caller
# errors like shape mismatch.
MISSING = (FileNotFoundError, zipfile.BadZipFile, EOFError, SnapshotCorrupt)

_CRC_KEY = "__crc32__"


def npz_path(path: str) -> str:
    """np.savez auto-appends .npz when given a filename; mirror that so
    save and load agree on the real destination."""
    return path if path.endswith(".npz") else path + ".npz"


def _payload_crc(arrays: dict) -> int:
    """CRC32 over names + raw bytes of every payload array, in sorted name
    order (layout-independent: the same logical contents always hash the
    same, whatever order the caller passed them in)."""
    crc = 0
    for name in sorted(arrays):
        if name == _CRC_KEY:
            continue
        arr = np.ascontiguousarray(np.asarray(arrays[name]))
        crc = zlib.crc32(name.encode(), crc)
        crc = zlib.crc32(arr.tobytes(), crc)
    return crc & 0xFFFFFFFF


def atomic_savez(path: str, **arrays) -> None:
    """Uncompressed atomic write (uint8 frames are near-incompressible and
    zlib would multiply the time any caller-held lock is taken)."""
    dest = npz_path(path)
    tmp = dest + ".tmp"
    arrays[_CRC_KEY] = np.uint32(_payload_crc(arrays))
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    if faults.get().fire("replay_snapshot_corrupt"):
        # chaos: tear the file below the atomic rename (what a mid-flush
        # host loss or disk corruption produces) — the CRC must catch it
        size = os.path.getsize(tmp)
        with open(tmp, "r+b") as f:
            f.truncate(max(size // 2, 1))
    os.replace(tmp, dest)


class _Verified(dict):
    """Eagerly-materialised snapshot payload with the NpzFile ``files``
    attribute callers already use (`"cuts" in z.files`)."""

    @property
    def files(self):
        return list(self.keys())


def load(path: str, verify: bool = True):
    """np.load of a snapshot; raises one of MISSING when absent/torn/corrupt.

    Verification is eager: the whole payload is read and checked against
    the stored CRC before anything is returned, so a restore either starts
    from a proven-whole snapshot or not at all.  Pre-CRC-era snapshots
    (no ``__crc32__`` entry) pass through unverified.
    """
    z = np.load(npz_path(path))
    if not verify or _CRC_KEY not in z.files:
        return z
    try:
        arrays = {name: z[name] for name in z.files if name != _CRC_KEY}
        stored = int(z[_CRC_KEY])
    except (zipfile.BadZipFile, zlib.error, ValueError, OSError) as e:
        # a torn entry surfaces while eagerly materialising the payload
        raise SnapshotCorrupt(f"{npz_path(path)}: unreadable payload: {e}") from e
    actual = _payload_crc(arrays)
    if actual != stored:
        raise SnapshotCorrupt(
            f"{npz_path(path)}: crc32 {actual:#010x} != recorded {stored:#010x}"
        )
    return _Verified(arrays)
