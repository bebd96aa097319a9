"""K5f: the device sample frontier's stratified draw with IS weights.

Replaces ``DeviceSampleFrontier``'s ``_draw``
(``rainbow_iqn_apex_tpu/replay/frontier.py:125-143``, dispatched by :253-268):

    idx    = K5 over the mirror p [N] f32 with uniforms U [G, B]     int32 [G, B]
    prob   = max(p[idx] / max(sum p, 1e-12), 1e-12)                  f32 [G, B]
    w      = (max(n_items, 1) * prob)^(-beta)
    weight = w / (max of w over each row of B)                       f32 [G, B]

Each of the G rows is one learner batch with its own max-normalised IS
weights.  The kernel's total is K5's nested sum, the twin's ``sum``, JAX's
``mirror.sum()``: prob and weight agree to about 1e-6 relative, and the ids
exactly only where the cdf is exact (dyadic priorities); elsewhere an id may
differ where u lies within rounding of a cdf boundary, as for K5.  beta and
n_items are rounded to fp32 first, as JAX's jit takes them.

Bound on the H100: one read of the mirror, 4 MB at N = 1,000,000.  The
kernel (``csrc/frontier_draw.cu``) runs K5's two launches (``replay_draw.py``)
and one epilogue block per row.

``queue`` (a ``frontier_writeback.MirrorQueue``, the frontier's staged
appends and write-backs since its last draw) is applied to the mirror first,
in place: on CUDA inside K5's first launch, each chunk block applying the
segments that touch its chunk before it sums it (K6f folded into K5f, no
launch of its own); the twin applies it with ``frontier_apply_plain``.

``frontier_draw`` runs the kernel for CUDA tensors and
``frontier_draw_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.kernels import build
from rainbow_iqn_apex_tpu_torch.kernels.frontier_writeback import (
    NAME as K6F_NAME,
    MirrorQueue,
    frontier_apply_plain,
)
from rainbow_iqn_apex_tpu_torch.kernels.replay_draw import CHUNK, replay_draw_plain

NAME = "K5f_frontier_draw"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/frontier_draw.cu"
REPLACES = "rainbow_iqn_apex_tpu/replay/frontier.py:125"
MAX_BATCH = 1024  # one epilogue block per row


def _f32(x: float) -> float:
    return float(np.float32(x))


def frontier_draw_plain(mirror: torch.Tensor, uniforms: torch.Tensor, beta: float,
                        n_items: float, queue: Optional[MirrorQueue] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mirror [N] f32, uniforms [G, B] f32 -> (idx [G, B] int32, prob, weight
    [G, B] f32): the queue's segments into the mirror, then cumsum,
    searchsorted, gather, pow, amax."""
    if queue is not None:
        frontier_apply_plain(mirror, queue)
    idx, total = replay_draw_plain(mirror, uniforms)
    prob = torch.clamp_min(mirror[idx.long()] / torch.clamp_min(total, 1e-12), 1e-12)
    w = torch.pow(_f32(max(n_items, 1.0)) * prob, -_f32(beta))
    return idx, prob, w / w.amax(dim=1, keepdim=True)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_frontier_draw
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def frontier_draw(mirror: torch.Tensor, uniforms: torch.Tensor, beta: float, n_items: float,
                  queue: Optional[MirrorQueue] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5f on ``mirror.device``: the kernel on CUDA, the plain twin on the
    CPU.  A non-empty ``queue`` is applied to the mirror first (and left as
    it was: the caller clears it)."""
    if mirror.device.type == "cpu":
        return frontier_draw_plain(mirror, uniforms, beta, n_items, queue)
    if mirror.dtype != torch.float32 or uniforms.dtype != torch.float32:
        raise TypeError("K5f takes an fp32 mirror and fp32 uniforms")
    if mirror.dim() != 1 or uniforms.dim() != 2:
        raise ValueError(f"K5f takes mirror [N] and uniforms [G, B], got "
                         f"{tuple(mirror.shape)} and {tuple(uniforms.shape)}")
    n = mirror.shape[0]
    groups, batch = uniforms.shape
    if not (0 < n < 2 ** 31 - CHUNK and 1 <= batch <= MAX_BATCH and groups >= 1
            and groups * batch < 2 ** 31):
        raise ValueError(f"K5f size out of range: N {n}, G {groups}, B {batch}")
    for t in (mirror, uniforms):
        if t.device != mirror.device or not t.is_contiguous():
            raise ValueError("K5f inputs must be contiguous on one device")
    if mirror.data_ptr() % 16:
        raise ValueError("K5f reads the mirror as 16-byte vectors: align it")
    if queue is not None and not len(queue):
        queue = None
    q = None if queue is None else queue.struct(mirror.device)
    chunks = -(-n // CHUNK)
    dev = mirror.device
    chunk_sums = torch.empty((chunks,), dtype=torch.float32, device=dev)
    idx = torch.empty((groups, batch), dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)
    prob = torch.empty((groups, batch), dtype=torch.float32, device=dev)
    weight = torch.empty((groups, batch), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _entry()(
            build.ptr(mirror), build.ptr(uniforms), build.ptr(chunk_sums), build.ptr(idx),
            build.ptr(total), build.ptr(prob), build.ptr(weight), n, groups, batch, _f32(beta),
            _f32(max(n_items, 1.0)), None if q is None else ctypes.byref(q),
            build.stream_of(dev))
    build.check_launch(NAME, code, fold=None if queue is None else K6F_NAME)
    return idx, prob, weight
