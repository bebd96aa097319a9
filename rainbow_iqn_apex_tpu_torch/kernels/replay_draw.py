"""K5: the stratified proportional PER draw of the device replay.

Replaces ``DeviceReplay.draw`` (``rainbow_iqn_apex_tpu/replay/device.py:207-220``)
and the G vmapped draws of ``sample_grouped`` (:309-310):

    total     = sum p                                  p [N] f32, the priorities p^omega
    u[g, k]   = (k + U[g, k]) / B * total              U [G, B] uniforms in [0, 1)
    idx[g, k] = clip(searchsorted(cumsum p, u, right), 0, N - 1)    int32

A slot with p = 0 is never drawn (its cdf equals its left neighbour's), and a
u that reaches the total lands on slot N - 1, as in JAX.  ``total`` stays on
the device: K8 and K5f read it.  fp32 sums in another order give another
cdf, so the kernel and the twin draw the same slots exactly only where the
cdf is exact (dyadic priorities) and elsewhere may differ where u lies within
rounding of a cdf boundary.

Bound on the H100: one read of p, 4 MB at N = 1,000,000 (~1.2 us).  The
kernel (``csrc/replay_draw.cu``) builds the cdf in nested levels (a thread's
four slots, the lanes of a warp, the warps of a 1,024-slot chunk, then the
same levels over the chunk sums), each chained in order so that the cdf is
non-decreasing in fp32 and a zero slot keeps its left neighbour's value, in
two launches: one block per chunk writes the chunk's sum, then one block per
draw scans the chunk sums, finds the chunk holding u and counts within it.
Its launches and the latency of each block's reads and barriers hold it
back, not bandwidth.

``replay_draw`` runs the kernel for CUDA tensors and ``replay_draw_plain``
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K5_replay_draw"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/replay_draw.cu"
REPLACES = "rainbow_iqn_apex_tpu/replay/device.py:207"
CHUNK = 1024  # slots per chunk of the kernel's scan: its scratch is one f32 a chunk


def replay_draw_plain(priority: torch.Tensor, uniforms: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """priority [N] f32, uniforms [G, B] f32 -> (idx [G, B] int32, total [] f32)."""
    n = priority.shape[0]
    batch = uniforms.shape[1]
    total = priority.sum()
    cdf = torch.cumsum(priority, 0)
    k = torch.arange(batch, dtype=torch.float32, device=priority.device)
    u = (k + uniforms) / batch * total
    idx = torch.searchsorted(cdf, u.contiguous(), right=True)
    return idx.clamp(0, n - 1).to(torch.int32), total


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_replay_draw
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def replay_draw(priority: torch.Tensor, uniforms: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 on ``priority.device``: the kernel on CUDA, the plain twin on the
    CPU.  A [0, B] ``uniforms`` computes the total only."""
    if priority.device.type == "cpu":
        return replay_draw_plain(priority, uniforms)
    if priority.dtype != torch.float32 or uniforms.dtype != torch.float32:
        raise TypeError("K5 takes fp32 priorities and uniforms")
    if priority.dim() != 1 or uniforms.dim() != 2:
        raise ValueError(f"K5 takes priority [N] and uniforms [G, B], got "
                         f"{tuple(priority.shape)} and {tuple(uniforms.shape)}")
    n = priority.shape[0]
    groups, batch = uniforms.shape
    if not 0 < n < 2 ** 31 - CHUNK or groups * batch >= 2 ** 31 or (groups and not batch):
        raise ValueError(f"K5 size out of range: N {n}, G {groups}, B {batch}")
    for t in (priority, uniforms):
        if t.device != priority.device or not t.is_contiguous():
            raise ValueError("K5 inputs must be contiguous on one device")
    if priority.data_ptr() % 16:
        raise ValueError("K5 reads the priorities as 16-byte vectors: align them")
    chunks = -(-n // CHUNK)
    chunk_sums = torch.empty((chunks,), dtype=torch.float32, device=priority.device)
    idx = torch.empty((groups, batch), dtype=torch.int32, device=priority.device)
    total = torch.empty((), dtype=torch.float32, device=priority.device)
    with torch.cuda.device(priority.device):
        code = _entry()(
            build.ptr(priority), build.ptr(uniforms), build.ptr(chunk_sums), build.ptr(idx),
            build.ptr(total), n, groups * batch, max(batch, 1), build.stream_of(priority.device))
    build.check_launch(NAME, code)
    return idx, total
