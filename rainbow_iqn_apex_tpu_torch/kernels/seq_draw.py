"""K5s: the stratified proportional draw of R2D2's device sequence replay.

Replaces ``DeviceSequenceReplay._effective_priority`` and ``draw``
(``rainbow_iqn_apex_tpu/replay/device_sequence.py:208-232``) and the G
vmapped draws of ``sample_grouped`` (:264-276):

    p_eff     = p if sum p > 0, else 1 on slots [0, F) and 0 after     F = max(filled, 1)
    total     = sum p_eff
    u[g, b]   = (b + U[g, b]) / B * total                  U [G, B] uniforms in [0, 1)
    idx[g, b] = clip(searchsorted(cumsum p_eff, u, right), 0, C - 1)    int32

The fallback to the uniform draw (a cold ring) is chosen on the device, and
``meta`` = [total, 1.0 if the fallback is on else 0.0] stays there: K8s
reads it.  fp32 sums in another order give another cdf, so the kernel, the
twin and JAX draw the same slots exactly where the cdf is exact (dyadic
priorities, the fallback) and elsewhere may differ where u lies within
rounding of a cdf boundary.

Bound on the H100: launch-bound (33 KB of priorities at C = 8,333).  The
kernel (``csrc/seq_draw.cu``) is one block: a levelled, monotone fp32 cdf
into a scratch vector, then a binary search per draw.

``seq_draw`` runs the kernel for CUDA tensors and ``seq_draw_plain`` for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K5s_seq_draw"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/seq_draw.cu"
REPLACES = "rainbow_iqn_apex_tpu/replay/device_sequence.py:221"


def seq_draw_plain(priority: torch.Tensor, filled: int, uniforms: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """priority [C] f32, the ring's filled count, uniforms [G, B] f32 ->
    (idx [G, B] int32, meta [2] f32 = (total, fallback))."""
    capacity = priority.shape[0]
    batch = uniforms.shape[1]
    warm = priority.sum() > 0.0
    uniform = (torch.arange(capacity, device=priority.device) < max(filled, 1)).to(torch.float32)
    p = torch.where(warm, priority, uniform)
    total = p.sum()
    cdf = torch.cumsum(p, 0)
    k = torch.arange(batch, dtype=torch.float32, device=priority.device)
    u = (k + uniforms) / batch * total
    idx = torch.searchsorted(cdf, u.contiguous(), right=True).clamp(0, capacity - 1)
    return idx.to(torch.int32), torch.stack([total, (~warm).to(torch.float32)])


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_seq_draw
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def seq_draw(priority: torch.Tensor, filled: int, uniforms: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5s on ``priority.device``: the kernel on CUDA, the plain twin on the
    CPU.  A [0, B] ``uniforms`` computes ``meta`` only."""
    if priority.device.type == "cpu":
        return seq_draw_plain(priority, filled, uniforms)
    if priority.dtype != torch.float32 or uniforms.dtype != torch.float32:
        raise TypeError("K5s takes fp32 priorities and uniforms")
    if priority.dim() != 1 or uniforms.dim() != 2:
        raise ValueError(f"K5s takes priority [C] and uniforms [G, B], got "
                         f"{tuple(priority.shape)} and {tuple(uniforms.shape)}")
    capacity = priority.shape[0]
    groups, batch = uniforms.shape
    if not (0 < capacity < 2 ** 31 and 0 <= filled <= capacity) or groups * batch >= 2 ** 31 or (
            groups and not batch):
        raise ValueError(f"K5s size out of range: C {capacity}, filled {filled}, G {groups}, "
                         f"B {batch}")
    for t in (priority, uniforms):
        if t.device != priority.device or not t.is_contiguous():
            raise ValueError("K5s inputs must be contiguous on one device")
    cdf = torch.empty((capacity,), dtype=torch.float32, device=priority.device)
    idx = torch.empty((groups, batch), dtype=torch.int32, device=priority.device)
    meta = torch.empty((2,), dtype=torch.float32, device=priority.device)
    with torch.cuda.device(priority.device):
        code = _entry()(build.ptr(priority), build.ptr(uniforms), build.ptr(cdf), build.ptr(idx),
                        build.ptr(meta), capacity, max(int(filled), 1), groups * batch,
                        max(batch, 1), build.stream_of(priority.device))
    build.check_launch(NAME, code)
    return idx, meta
