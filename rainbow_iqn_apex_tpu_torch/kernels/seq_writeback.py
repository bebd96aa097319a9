"""K6s: the priority write-back of R2D2's device sequence replay.

Replaces ``DeviceSequenceReplay.update_priorities`` and
``update_priorities_grouped``
(``rainbow_iqn_apex_tpu/replay/device_sequence.py:285-305``), in place:

    pri           = (td_mix + eps)^omega                     [G, B] f32
    max_priority  = max(max_priority, max pri)
    for g in order: p[idx[g]] = pri[g]                       a direct set

Unlike K6 there is no never-resurrect fence: the sequence ring never
invalidates a slot.  On a repeated id the last group wins and, inside a
group, the last occurrence: a deliberate choice where the JAX scatter
leaves the order open.  The priorities are fp32, as in the JAX device
module (the host ``SequenceReplay`` computes them in float64); omega = 0.5
takes a square root, as XLA and torch do for that power.

Bound on the H100: a few KB, launch-bound.  The kernel is K6's
(``csrc/replay_writeback.cu``, entry ``port_seq_writeback``) without its
fence: one block with a barrier between each group's reads and writes.

``seq_writeback`` runs the kernel for CUDA tensors and
``seq_writeback_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build
from rainbow_iqn_apex_tpu_torch.kernels.replay_writeback import priority_power

NAME = "K6s_seq_writeback"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/replay_writeback.cu"
REPLACES = "rainbow_iqn_apex_tpu/replay/device_sequence.py:285"


def seq_writeback_plain(priority: torch.Tensor, max_priority: torch.Tensor, idx: torch.Tensor,
                        td_mix: torch.Tensor, eps: float, omega: float) -> None:
    """priority [C] and max_priority [] f32 in place; idx [G, B] int32,
    td_mix [G * B] or [G, B] f32."""
    groups, batch = idx.shape
    pri = priority_power(td_mix.reshape(groups, batch).to(torch.float32) + eps, omega)
    max_priority.copy_(torch.maximum(max_priority, pri.max()))
    order = torch.arange(batch, device=idx.device)
    for g in range(groups):
        ids = idx[g].long()
        # every occurrence of an id writes its last occurrence's value
        last = torch.where(ids[:, None] == ids[None, :], order, -1).amax(dim=1)
        priority.index_put_((ids,), pri[g][last])


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_seq_writeback
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def seq_writeback(priority: torch.Tensor, max_priority: torch.Tensor, idx: torch.Tensor,
                  td_mix: torch.Tensor, eps: float, omega: float) -> None:
    """K6s on ``priority.device``: the kernel on CUDA, the plain twin on the CPU."""
    if priority.device.type == "cpu":
        return seq_writeback_plain(priority, max_priority, idx, td_mix, eps, omega)
    if idx.dim() != 2:
        raise ValueError(f"K6s takes idx [G, B], got {tuple(idx.shape)}")
    groups, batch = idx.shape
    if not (groups >= 1 and 1 <= batch <= 1024):
        raise ValueError(f"K6s runs one block: 1 <= B <= 1024 and G >= 1, got G {groups}, "
                         f"B {batch}")
    if (priority.dtype, max_priority.dtype, idx.dtype, td_mix.dtype) != (
            torch.float32, torch.float32, torch.int32, torch.float32):
        raise TypeError("K6s takes fp32 priorities, max_priority and td_mix, int32 idx")
    if td_mix.numel() != groups * batch or max_priority.dim() != 0 or priority.dim() != 1:
        raise ValueError("K6s shape mismatch: priority [C], max_priority [], td_mix [G * B]")
    for t in (priority, max_priority, idx, td_mix):
        if t.device != priority.device or not t.is_contiguous():
            raise ValueError("K6s inputs must be contiguous on one device")
    with torch.cuda.device(priority.device):
        code = _entry()(build.ptr(priority), build.ptr(max_priority), build.ptr(idx),
                        build.ptr(td_mix), priority.numel(), groups, batch, float(eps),
                        float(omega), build.stream_of(priority.device))
    build.check_launch(NAME, code)
