"""K6f: the device sample frontier's fenced write-back into the mirror.

Replaces ``DeviceSampleFrontier``'s ``_writeback``
(``rainbow_iqn_apex_tpu/replay/frontier.py:145-153``, dispatched by :271-286),
in place:

    pri          = (|td| + eps)^omega                                f32 [B]
    mirror[idx]  = where(mirror[idx] > 0, pri, 0)                    never resurrect a slot

No max priority is kept (K6 keeps one; the frontier leaves the fresh-item
default to the host trees).  A repeated id is written with its last
occurrence's value; JAX leaves their order open (frontier.py:275-277).
omega = 0.5 takes a square root.  The kernel drops an id outside [0, N);
the twin raises on one.

Bound on the H100: a few hundred bytes at B = 32, launch-bound.  The kernel
(``csrc/frontier_writeback.cu``) is one block with a barrier between the
fence reads and the writes.

``frontier_writeback`` runs the kernel for CUDA tensors and
``frontier_writeback_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build
from rainbow_iqn_apex_tpu_torch.kernels.replay_writeback import priority_power

NAME = "K6f_frontier_writeback"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/frontier_writeback.cu"
REPLACES = "rainbow_iqn_apex_tpu/replay/frontier.py:145"


def frontier_writeback_plain(mirror: torch.Tensor, idx: torch.Tensor, td: torch.Tensor,
                             eps: float, omega: float) -> None:
    """mirror [N] f32 in place; idx [B] int32, td [B] f32."""
    ids = idx.long()
    pri = priority_power(td.to(torch.float32).abs() + eps, omega)
    value = torch.where(mirror[ids] > 0, pri, torch.zeros_like(pri))
    order = torch.arange(ids.shape[0], device=ids.device)
    # every occurrence of an id writes its last occurrence's value, so the
    # scatter's order among duplicates does not matter
    last = torch.where(ids[:, None] == ids[None, :], order, -1).amax(dim=1)
    mirror.index_put_((ids,), value[last])


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_frontier_writeback
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def frontier_writeback(mirror: torch.Tensor, idx: torch.Tensor, td: torch.Tensor,
                       eps: float, omega: float) -> None:
    """K6f on ``mirror.device``: the kernel on CUDA, the plain twin on the CPU."""
    if mirror.device.type == "cpu":
        return frontier_writeback_plain(mirror, idx, td, eps, omega)
    if (mirror.dtype, idx.dtype, td.dtype) != (torch.float32, torch.int32, torch.float32):
        raise TypeError("K6f takes an fp32 mirror and td, int32 idx")
    if mirror.dim() != 1 or idx.dim() != 1 or td.shape != idx.shape:
        raise ValueError(f"K6f takes mirror [N], idx [B] and td [B], got {tuple(mirror.shape)}, "
                         f"{tuple(idx.shape)} and {tuple(td.shape)}")
    batch = idx.shape[0]
    if not 1 <= batch <= 1024:
        raise ValueError(f"K6f runs one block: 1 <= B <= 1024, got B {batch}")
    for t in (mirror, idx, td):
        if t.device != mirror.device or not t.is_contiguous():
            raise ValueError("K6f inputs must be contiguous on one device")
    with torch.cuda.device(mirror.device):
        code = _entry()(build.ptr(mirror), build.ptr(idx), build.ptr(td), mirror.numel(), batch,
                        float(eps), float(omega), build.stream_of(mirror.device))
    build.check_launch(NAME, code)
