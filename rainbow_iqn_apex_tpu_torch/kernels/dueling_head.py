"""K4: dueling combine, mean over tau and greedy argmax in one launch.

Replaces the dueling combine of ``rainbow_iqn_apex_tpu/models/iqn.py``
(:94-101) and its ``q_values`` / ``greedy_action`` (:105-111), which XLA
fuses on the TPU:

    quantiles = v + a - mean_a(a)    [B, N, A]   (a alone without dueling)
    q         = mean_tau quantiles   [B, A]
    action    = argmax_a q           [B] int32, the first index on ties

Bound on the H100: a few hundred KB at bucket 64, far under a microsecond of
memory time, so the launch is the cost.  The kernel
(``csrc/dueling_head.cu``) does all three steps in one block per batch row.

``dueling_head`` runs the kernel for CUDA tensors and ``dueling_head_plain``
for CPU tensors.

The learner's use of K4 (``ops/learn.py:140`` and ``:152``): ``dueling_gather``
runs the same kernel in gather mode, returning z [B, N] = quantiles at given
actions and q [B, A], and K4-bwd (``dueling_gather_bwd``, kernel
``csrc/dueling_head_bwd.cu``) is its backward: dvalue = dz, dadv = dz *
(1{a = a_b} - 1/A).  Both launch-bound.  ``DuelingGatherFn`` is the
``torch.autograd.Function`` over them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K4_dueling_head"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/dueling_head.cu"
REPLACES = "rainbow_iqn_apex_tpu/models/iqn.py:94"
NAME_BWD = NAME + "_bwd"
SOURCE_BWD = "rainbow_iqn_apex_tpu_torch/csrc/dueling_head_bwd.cu"
REPLACES_BWD = "rainbow_iqn_apex_tpu/ops/learn.py:152"


def dueling_head_plain(value: Optional[torch.Tensor], adv: torch.Tensor,
                       num_taus: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """value [B*N, 1] or None, adv [B*N, A] fp32 -> (quantiles [B, N, A],
    q [B, A], action [B] int32)."""
    q_all = adv if value is None else value + adv - adv.mean(dim=-1, keepdim=True)
    quantiles = q_all.reshape(-1, num_taus, adv.shape[-1]).float()
    q = quantiles.mean(dim=1)
    return quantiles, q, torch.argmax(q, dim=-1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_dueling_head
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(value: Optional[torch.Tensor], adv: torch.Tensor, num_taus: int) -> None:
    rows, actions = adv.shape
    if rows % num_taus:
        raise ValueError(f"K4: {rows} rows are not a multiple of {num_taus} taus")
    tensors = (adv,) if value is None else (value, adv)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("K4 takes fp32 value and advantage")
    if value is not None and tuple(value.shape) != (rows, 1):
        raise ValueError(f"K4 value must be [{rows}, 1], got {tuple(value.shape)}")
    if any(t.device != adv.device or not t.is_contiguous() for t in tensors):
        raise ValueError("K4 inputs must be contiguous on one device")
    if (num_taus + 1) * actions > 12288:
        raise ValueError("K4 keeps one row's [N, A] quantiles in 48 KB of shared memory")


def dueling_head(value: Optional[torch.Tensor], adv: torch.Tensor,
                 num_taus: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 on ``adv.device``: the kernel on CUDA, the plain twin on the CPU."""
    if adv.device.type == "cpu":
        return dueling_head_plain(value, adv, num_taus)
    _check(value, adv, num_taus)
    rows, actions = adv.shape
    batch = rows // num_taus
    quantiles = torch.empty((batch, num_taus, actions), dtype=torch.float32, device=adv.device)
    q = torch.empty((batch, actions), dtype=torch.float32, device=adv.device)
    action = torch.empty((batch,), dtype=torch.int32, device=adv.device)
    with torch.cuda.device(adv.device):
        code = _entry()(
            build.ptr(value), build.ptr(adv), build.ptr(quantiles), build.ptr(q),
            build.ptr(action), build.ptr(None), build.ptr(None), batch, num_taus, actions,
            build.stream_of(adv.device))
    build.check_launch(NAME, code)
    return quantiles, q, action


def dueling_gather_plain(value: Optional[torch.Tensor], adv: torch.Tensor, num_taus: int,
                         take: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """value [B*N, 1] or None, adv [B*N, A] fp32, take [B] int32 ->
    (z [B, N] = quantiles[b, :, take[b]], q [B, A])."""
    quantiles, q, _ = dueling_head_plain(value, adv, num_taus)
    index = take.long()[:, None, None].expand(-1, num_taus, 1)
    return torch.gather(quantiles, 2, index)[..., 0], q


def dueling_gather(value: Optional[torch.Tensor], adv: torch.Tensor, num_taus: int,
                   take: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 in gather mode on ``adv.device``: the kernel on CUDA, the plain
    twin on the CPU.  An action out of range gathers NaN on CUDA."""
    if adv.device.type == "cpu":
        return dueling_gather_plain(value, adv, num_taus, take)
    _check(value, adv, num_taus)
    rows, actions = adv.shape
    batch = rows // num_taus
    if take.dtype != torch.int32 or tuple(take.shape) != (batch,):
        raise ValueError(f"K4 gather takes int32 actions [{batch}], got {take.dtype} "
                         f"{tuple(take.shape)}")
    if take.device != adv.device or not take.is_contiguous():
        raise ValueError("K4 inputs must be contiguous on one device")
    z = torch.empty((batch, num_taus), dtype=torch.float32, device=adv.device)
    q = torch.empty((batch, actions), dtype=torch.float32, device=adv.device)
    with torch.cuda.device(adv.device):
        code = _entry()(
            build.ptr(value), build.ptr(adv), build.ptr(None), build.ptr(q), build.ptr(None),
            build.ptr(take), build.ptr(z), batch, num_taus, actions,
            build.stream_of(adv.device))
    build.check_launch(NAME, code)
    return z, q


def dueling_gather_bwd_plain(dz: torch.Tensor, take: torch.Tensor, num_actions: int,
                             dueling: bool) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Backward of the gather mode for dz [B, N] fp32 -> (dvalue [B*N, 1]
    or None, dadv [B*N, A])."""
    batch, num_taus = dz.shape
    onehot = torch.nn.functional.one_hot(take.long(), num_actions).to(dz.dtype)  # [B, A]
    dq = dz[:, :, None] * onehot[:, None, :]  # [B, N, A]
    if not dueling:
        return None, dq.reshape(batch * num_taus, num_actions)
    dadv = dq - dz[:, :, None] / num_actions
    return dz.reshape(batch * num_taus, 1), dadv.reshape(batch * num_taus, num_actions)


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = build.library().port_dueling_head_bwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dueling_gather_bwd(dz: torch.Tensor, take: torch.Tensor, num_actions: int,
                       dueling: bool) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """K4-bwd on ``dz.device``: the kernel on CUDA, the plain twin on the CPU."""
    if dz.device.type == "cpu":
        return dueling_gather_bwd_plain(dz, take, num_actions, dueling)
    batch, num_taus = dz.shape
    if dz.dtype != torch.float32 or take.dtype != torch.int32:
        raise TypeError("K4-bwd takes fp32 dz and int32 actions")
    if tuple(take.shape) != (batch,):
        raise ValueError(f"K4-bwd actions must be [{batch}], got {tuple(take.shape)}")
    for t in (dz, take):
        if t.device != dz.device or not t.is_contiguous():
            raise ValueError("K4-bwd inputs must be contiguous on one device")
    rows = batch * num_taus
    dvalue = torch.empty((rows, 1), dtype=torch.float32, device=dz.device) if dueling else None
    dadv = torch.empty((rows, num_actions), dtype=torch.float32, device=dz.device)
    with torch.cuda.device(dz.device):
        code = _bwd_entry()(build.ptr(dz), build.ptr(take), build.ptr(dvalue), build.ptr(dadv),
                            batch, num_taus, num_actions, build.stream_of(dz.device))
    build.check_launch(NAME_BWD, code)
    return dvalue, dadv


class DuelingGatherFn(torch.autograd.Function):
    """K4 gather forward, K4-bwd backward: (value, adv, take, num_taus) ->
    (z [B, N], q [B, A]), differentiable in value and adv through z; q (the
    q_mean metric's source) carries no gradient."""

    @staticmethod
    def forward(ctx, value, adv, take, num_taus):
        z, q = dueling_gather(value, adv, num_taus, take)
        ctx.save_for_backward(take)
        ctx.dueling = value is not None
        ctx.num_actions = adv.shape[1]
        ctx.mark_non_differentiable(q)
        return z, q

    @staticmethod
    def backward(ctx, dz, dq):
        (take,) = ctx.saved_tensors
        dvalue, dadv = dueling_gather_bwd(dz.contiguous(), take, ctx.num_actions, ctx.dueling)
        return dvalue, dadv, None, None
