"""K11: the R2D2 TD and priority epilogue (loss, priorities, q mean and the
loss's gradient in q_taken) in one launch.

Replaces the ``loss_fn`` of ``rainbow_iqn_apex_tpu/ops/r2d2.py``
``build_r2d2_learn_step`` (:196-260) with ``value_rescale`` /
``value_unrescale`` (:33-43): the double-Q bootstrap through h^-1, the
n-step windowed return cut at terminals, y = h(R + gamma^n alive q_boot),
the valid / target-ok mask, the masked Huber(1) summed per sequence over the
mask count, IS-weighted and averaged over B, and the priorities eta max|td|
+ (1 - eta) mean|td|.  Launch-bound (~0.4 MB); the kernel
(``csrc/r2d2_td.cu``) runs one block per sequence.

``r2d2_td`` runs the kernel for CUDA tensors and ``r2d2_td_plain`` for CPU
tensors; ``R2D2TDFn`` is the ``torch.autograd.Function`` whose backward
scales the kernel's d loss / d q_taken by the incoming gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K11_r2d2_td"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/r2d2_td.cu"
REPLACES = "rainbow_iqn_apex_tpu/ops/r2d2.py:196"


class TDParams(NamedTuple):
    """The step's constants as the config gives them (Python floats).  The
    kernel takes gamma ** n, 1 - eta, 4 eps and 2 eps each rounded to fp32
    from double, as JAX folds the source's Python-float expressions."""

    n: int
    gamma: float
    eta: float
    eps: float


def value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """h(x) = sign(x) * (sqrt(|x| + 1) - 1) + eps * x."""
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def value_unrescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """h^-1, the closed form of the R2D2 appendix."""
    inner = torch.sqrt(1.0 + (4.0 * eps) * (torch.abs(x) + 1.0 + eps)) - 1.0
    r = inner / (2.0 * eps)
    return torch.sign(x) * (r * r - 1.0)


def _huber(u: torch.Tensor) -> torch.Tensor:
    a = torch.abs(u)
    return torch.where(a <= 1.0, 0.5 * (u * u), a - 0.5)


def r2d2_td_plain(q_taken, q_sel, q_tgt, reward, done, valid, weight, p: TDParams):
    """q_taken [B, T], q_sel / q_tgt [B, T, A], reward [B, T] fp32, done /
    valid [B, T] bool, weight [B] -> (loss [], priorities [B], q_mean [],
    d loss / d q_taken [B, T])."""
    batch, steps = q_taken.shape
    n, tn = p.n, steps - p.n
    f32 = torch.float32
    d, v = done.to(f32), valid.to(f32)
    a_star = torch.argmax(q_sel, dim=-1, keepdim=True)
    q_boot = value_unrescale(torch.gather(q_tgt, 2, a_star)[..., 0], p.eps)
    rn = torch.zeros((batch, tn), dtype=f32, device=q_taken.device)
    alive = torch.ones_like(rn)
    dsum = torch.zeros_like(rn)
    gk = 1.0
    for k in range(n):
        dk = d[:, k:k + tn]
        rn = rn + reward[:, k:k + tn] * alive * gk
        alive = alive * (1.0 - dk)
        gk = float(np.float32(gk * np.float32(p.gamma)))  # the kernel's fp32 product
        dsum = dsum + dk
    done_w = torch.clamp(dsum, 0.0, 1.0)
    y = value_rescale(rn + p.gamma ** n * (1.0 - done_w) * q_boot[:, n:], p.eps)
    mask = v[:, :tn] * torch.clamp(done_w + v[:, n:], 0.0, 1.0)
    td = (y - q_taken[:, :tn]) * mask
    denom = torch.clamp(mask.sum(dim=1), min=1.0)
    per_seq = _huber(td).sum(dim=1) / denom
    loss = torch.mean(weight * per_seq)
    abs_td = torch.abs(td)
    priorities = p.eta * abs_td.max(dim=1).values + (1.0 - p.eta) * (abs_td.sum(dim=1) / denom)
    q_mean = (q_taken * v).sum() / torch.clamp(v.sum(), min=1.0)
    grad = torch.zeros_like(q_taken)
    grad[:, :tn] = -(weight / batch)[:, None] / denom[:, None] * torch.clamp(td, -1.0, 1.0) * mask
    return loss, priorities, q_mean, grad


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_r2d2_td
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_float] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def r2d2_td(q_taken, q_sel, q_tgt, reward, done, valid, weight, p: TDParams):
    """K11 on ``q_taken.device``: the kernel on CUDA, the plain twin on the CPU."""
    if q_taken.device.type == "cpu":
        return r2d2_td_plain(q_taken, q_sel, q_tgt, reward, done, valid, weight, p)
    batch, steps = q_taken.shape
    actions = q_sel.shape[-1]
    want = {"q_taken": ((batch, steps), torch.float32),
            "q_sel": ((batch, steps, actions), torch.float32),
            "q_tgt": ((batch, steps, actions), torch.float32),
            "reward": ((batch, steps), torch.float32), "done": ((batch, steps), torch.bool),
            "valid": ((batch, steps), torch.bool), "weight": ((batch,), torch.float32)}
    given = dict(q_taken=q_taken, q_sel=q_sel, q_tgt=q_tgt, reward=reward, done=done,
                 valid=valid, weight=weight)
    for name, t in given.items():
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"K11: {name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != q_taken.device or not t.is_contiguous():
            raise ValueError("K11 inputs must be contiguous on one device")
    if not 1 <= p.n < steps:
        raise ValueError(f"K11: n = {p.n} must be in [1, {steps})")
    dev = q_taken.device
    loss = torch.empty((), dtype=torch.float32, device=dev)
    q_mean = torch.empty((), dtype=torch.float32, device=dev)
    priorities = torch.empty((batch,), dtype=torch.float32, device=dev)
    dq = torch.empty((batch, steps), dtype=torch.float32, device=dev)
    scratch = torch.zeros((3 * batch + 1,), dtype=torch.float32, device=dev)  # partials, ticket
    with torch.cuda.device(dev):
        code = _entry()(
            *(build.ptr(t) for t in given.values()), build.ptr(loss), build.ptr(priorities),
            build.ptr(q_mean), build.ptr(dq), build.ptr(scratch),
            build.ptr(scratch[3 * batch:]), batch, steps, actions, p.n, p.gamma, p.gamma ** p.n,
            p.eta, 1.0 - p.eta, p.eps, 4.0 * p.eps, 2.0 * p.eps, build.stream_of(dev))
    build.check_launch(NAME, code)
    return loss, priorities, q_mean, dq


class R2D2TDFn(torch.autograd.Function):
    """K11 forward; backward = its d loss / d q_taken times the incoming
    gradient.  (q_taken, q_sel, q_tgt, reward, done, valid, weight, params)
    -> (loss, priorities, q_mean); only loss is differentiable, in q_taken."""

    @staticmethod
    def forward(ctx, q_taken, q_sel, q_tgt, reward, done, valid, weight, params):
        loss, priorities, q_mean, dq = r2d2_td(q_taken, q_sel, q_tgt, reward, done, valid,
                                               weight, params)
        ctx.save_for_backward(dq)
        ctx.mark_non_differentiable(priorities, q_mean)
        return loss, priorities, q_mean

    @staticmethod
    def backward(ctx, dloss, dpriorities, dq_mean):
        (dq,) = ctx.saved_tensors
        return dq * dloss, None, None, None, None, None, None, None
