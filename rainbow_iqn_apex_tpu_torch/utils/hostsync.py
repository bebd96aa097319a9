"""The host<->device sync seam of the port: every *sanctioned* blocking
device->host read in the learner hot path goes through this module, and a
region can forbid everything else.

Counterpart of ``rainbow_iqn_apex_tpu/utils/hostsync.py`` for torch.  The
learner loop's floor is the device step time only while the host never
blocks on a device value mid-loop: one stray ``.item()``, ``bool(tensor)``
or copy to pageable memory re-serializes the pipeline.

- ``to_host(x)`` / ``scalar(x)``: the sanctioned reads (write-back ring
  retirement, supervisor snapshots, cadence reads).  Inside a
  ``forbid_host_sync()`` region they work only under ``sanctioned()``.
- ``check_host_work(tag)``: the same fence for tagged host-side hot-path
  work rather than transfers (host replay sampling).
- ``forbid_host_sync()``: on CUDA, ``torch.cuda.set_sync_debug_mode("error")``,
  so any operation that synchronizes the device with the host (``.item()``,
  ``bool()`` of a CUDA tensor, ``nonzero``, a blocking copy) raises; on
  every device, the thread-local flag that ``to_host``/``scalar``/
  ``check_host_work`` consult.  ``sanctioned()`` lifts both.

Thread story: the flags are thread-local, so ``to_host``/``scalar``/
``check_host_work`` fence only the thread that entered the region.  CUDA's
sync debug mode is process-wide, so while a region is open a worker thread
that synchronizes (the prefetcher never does: it copies from pinned memory
without blocking) would raise as well.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any

import numpy as np
import torch


class HostSyncError(RuntimeError):
    """A blocking device->host read inside a no-sync region."""


_tls = threading.local()
_mode_lock = threading.Lock()
_forbid_depth = 0  # process-wide: open forbid_host_sync() regions
_sanction_depth = 0  # process-wide: open sanctioned() blocks
_strict = False  # whether CUDA's sync debug mode is "error" now


def _forbidden() -> bool:
    return getattr(_tls, "forbid", 0) > 0 and getattr(_tls, "sanction", 0) == 0


def _apply_mode_locked() -> None:
    global _strict
    strict = _forbid_depth > 0 and _sanction_depth == 0
    if strict != _strict and torch.cuda.is_available():
        torch.cuda.set_sync_debug_mode("error" if strict else "default")
        _strict = strict


@contextlib.contextmanager
def sanctioned():
    """Mark the enclosed block as an allowed sync point.  Composes with an
    enclosing ``forbid_host_sync()``: syncs inside are allowed again."""
    global _sanction_depth
    _tls.sanction = getattr(_tls, "sanction", 0) + 1
    with _mode_lock:
        _sanction_depth += 1
        _apply_mode_locked()
    try:
        yield
    finally:
        _tls.sanction -= 1
        with _mode_lock:
            _sanction_depth -= 1
            _apply_mode_locked()


def to_host(x: Any) -> np.ndarray:
    """Materialize a (possibly device) tensor on the host — THE sanctioned
    device->host array copy of the hot path."""
    if isinstance(x, np.ndarray):
        return x
    if _forbidden():
        raise HostSyncError("to_host() outside a sanctioned() block inside a no-sync region")
    with sanctioned():
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_host_work(tag: str) -> None:
    """Forbidden-set membership check for tagged host-side hot-path WORK
    (``PrioritizedReplay.sample`` calls it): a learner thread inside
    ``forbid_host_sync()`` must delegate it to a worker (the prefetcher) or
    wrap a cold-path call in ``sanctioned()``."""
    if _forbidden():
        raise HostSyncError(
            f"host-side '{tag}' on a thread inside a forbid_host_sync() "
            "region (delegate it to a worker, or wrap a cold-path call in "
            "sanctioned())")


def scalar(x: Any) -> float:
    """Materialize a scalar on the host (blocks until the value is ready)."""
    if isinstance(x, (float, int)):
        return float(x)
    if _forbidden():
        raise HostSyncError("scalar() outside a sanctioned() block inside a no-sync region")
    with sanctioned():
        return float(x.item()) if isinstance(x, torch.Tensor) else float(x)


@contextlib.contextmanager
def forbid_host_sync():
    """Inside this context a blocking device->host read on the current
    thread outside ``sanctioned()`` raises: ``HostSyncError`` from this
    module's reads, and CUDA's sync debug error from torch itself."""
    global _forbid_depth
    _tls.forbid = getattr(_tls, "forbid", 0) + 1
    with _mode_lock:
        _forbid_depth += 1
        _apply_mode_locked()
    try:
        yield
    finally:
        _tls.forbid -= 1
        with _mode_lock:
            _forbid_depth -= 1
            _apply_mode_locked()
