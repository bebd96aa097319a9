"""K6: the fenced priority write-back of the device replay.

Replaces ``DeviceReplay.update_priorities`` and ``update_priorities_grouped``
(``rainbow_iqn_apex_tpu/replay/device.py:335-346``, :321-333), in place:

    pri           = (td_abs + eps)^omega                     [G, B] f32
    max_priority  = max(max_priority, max pri)               taken before the fence
    for g in order: p[idx[g]] = where(p[idx[g]] > 0, pri[g], 0)   never resurrect a slot

Inside a group the fence reads the values from before the group and the last
occurrence of a repeated id is written; group g reads what the earlier
groups left (the JAX package's ordered scatters and the host replay's
sequential update).  omega = 0.5 takes a square root, as XLA and torch do
for that power.  The kernel drops an id outside [0, N) (as XLA drops an
out-of-bounds scatter update); the twin raises on one.

Bound on the H100: a few KB at G * B = 128, launch-bound.  The kernel
(``csrc/replay_writeback.cu``) is one block with a barrier between each
group's fence reads and its writes.  The fused Anakin step launches none:
it hands a ``Writeback`` target to K1's weighted mode, whose launch does
this write-back of the td_abs it computes (``quantile_huber_weighted``,
through the same ``scatter_group`` of ``csrc/writeback.cuh``).

``replay_writeback`` runs the kernel for CUDA tensors and
``replay_writeback_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K6_replay_writeback"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/replay_writeback.cu"
REPLACES = "rainbow_iqn_apex_tpu/replay/device.py:335"


class Writeback(NamedTuple):
    """Where a learn step's priorities go: the device ring's ``priority``
    [N] and ``max_priority`` [] f32 (updated in place), the draws' ``idx``
    [G, B] int32, and the ring's ``eps`` and ``omega``."""

    priority: torch.Tensor
    max_priority: torch.Tensor
    idx: torch.Tensor
    eps: float
    omega: float


def priority_power(x: torch.Tensor, omega: float) -> torch.Tensor:
    """x^omega, a square root at omega = 0.5 (as the kernels compute it)."""
    return torch.sqrt(x) if omega == 0.5 else torch.pow(x, omega)


def replay_writeback_plain(priority: torch.Tensor, max_priority: torch.Tensor,
                           idx: torch.Tensor, td_abs: torch.Tensor,
                           eps: float, omega: float) -> None:
    """priority [N] and max_priority [] f32 in place; idx [G, B] int32,
    td_abs [G * B] or [G, B] f32."""
    groups, batch = idx.shape
    pri = priority_power(td_abs.reshape(groups, batch).to(torch.float32) + eps, omega)
    max_priority.copy_(torch.maximum(max_priority, pri.max()))
    order = torch.arange(batch, device=idx.device)
    for g in range(groups):
        ids = idx[g].long()
        value = torch.where(priority[ids] > 0, pri[g], torch.zeros_like(pri[g]))
        # every occurrence of an id writes its last occurrence's value, so
        # the scatter's order among duplicates does not matter
        last = torch.where(ids[:, None] == ids[None, :], order, -1).amax(dim=1)
        priority.index_put_((ids,), value[last])


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_replay_writeback
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def replay_writeback(priority: torch.Tensor, max_priority: torch.Tensor, idx: torch.Tensor,
                     td_abs: torch.Tensor, eps: float, omega: float) -> None:
    """K6 on ``priority.device``: the kernel on CUDA, the plain twin on the CPU."""
    if priority.device.type == "cpu":
        return replay_writeback_plain(priority, max_priority, idx, td_abs, eps, omega)
    if idx.dim() != 2:
        raise ValueError(f"K6 takes idx [G, B], got {tuple(idx.shape)}")
    groups, batch = idx.shape
    if not (groups >= 1 and 1 <= batch <= 1024):
        raise ValueError(f"K6 runs one block: 1 <= B <= 1024 and G >= 1, got G {groups}, B {batch}")
    if (priority.dtype, max_priority.dtype, idx.dtype, td_abs.dtype) != (
            torch.float32, torch.float32, torch.int32, torch.float32):
        raise TypeError("K6 takes fp32 priorities, max_priority and td_abs, int32 idx")
    if td_abs.numel() != groups * batch or max_priority.dim() != 0 or priority.dim() != 1:
        raise ValueError("K6 shape mismatch: priority [N], max_priority [], td_abs [G * B]")
    for t in (priority, max_priority, idx, td_abs):
        if t.device != priority.device or not t.is_contiguous():
            raise ValueError("K6 inputs must be contiguous on one device")
    with torch.cuda.device(priority.device):
        code = _entry()(build.ptr(priority), build.ptr(max_priority), build.ptr(idx),
                        build.ptr(td_abs), priority.numel(), groups, batch, float(eps),
                        float(omega), build.stream_of(priority.device))
    build.check_launch(NAME, code)
