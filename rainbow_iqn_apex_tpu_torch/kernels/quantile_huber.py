"""K1: the pairwise quantile-Huber loss of IQN, with its gradient.

Replaces the Pallas kernel the JAX package once had for this loss (its
``_qh_kernel`` and custom VJP; the live reference is
``rainbow_iqn_apex_tpu/ops/losses.py:31`` ``quantile_huber_loss``):

    u_ij      = target_j - online_i
    rho_ij    = |tau_i - 1{u_ij < 0}| * Huber_k(u_ij) / k
    loss_b    = sum_i mean_j rho_ij                  [B]
    td_abs_b  = mean_ij |u_ij|                       [B]
    grad_b,i  = d loss_b / d online_i = -(1/N') sum_j |tau_i - 1{u<0}| clip(u, -k, k) / k

As the Pallas kernel did, the forward returns the gradient with the loss, so
the autograd backward (``QuantileHuberFn``) only scales it by the upstream
cotangent, an elementwise torch op.  Taus and targets get no gradient (the
targets are under ``stop_gradient`` in the JAX learner).

Bound on the H100: ~24 KB of inputs at B = 32, N = N' = 64, so the kernel is
launch-bound.  The kernel (``csrc/quantile_huber.cu``) runs one block per
sample and keeps the [N, N'] pair tile on chip.

``quantile_huber`` runs the kernel for CUDA tensors and
``quantile_huber_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K1_quantile_huber"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/quantile_huber.cu"
REPLACES = "rainbow_iqn_apex_tpu/ops/losses.py:31"


def quantile_huber_plain(online: torch.Tensor, taus: torch.Tensor, target: torch.Tensor,
                         kappa: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """online, taus [B, N] and target [B, N'] fp32 -> (loss [B], td_abs [B],
    grad [B, N]), as ``ops/losses.py`` computes loss and td_abs and
    ``jax.grad`` computes grad."""
    u = target[:, None, :] - online[:, :, None]  # [B, N, N']
    weight = torch.abs(taus[:, :, None] - (u < 0).to(u.dtype))
    abs_u = torch.abs(u)
    huber = torch.where(abs_u <= kappa, 0.5 * u * u, kappa * (abs_u - 0.5 * kappa))
    loss = (weight * huber / kappa).mean(dim=2).sum(dim=1)
    td_abs = abs_u.mean(dim=(1, 2))
    grad = -(weight * torch.clamp(u, -kappa, kappa) / kappa).mean(dim=2)
    return loss, td_abs, grad


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_quantile_huber
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantile_huber(online: torch.Tensor, taus: torch.Tensor, target: torch.Tensor,
                   kappa: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 on ``online.device``: the kernel on CUDA, the plain twin on the CPU."""
    if online.device.type == "cpu":
        return quantile_huber_plain(online, taus, target, kappa)
    batch, n = online.shape
    n_target = target.shape[1]
    if any(t.dtype != torch.float32 for t in (online, taus, target)):
        raise TypeError("K1 takes fp32 online quantiles, taus and targets")
    if tuple(taus.shape) != (batch, n) or target.shape[0] != batch:
        raise ValueError(f"K1 shape mismatch: online {tuple(online.shape)}, taus "
                         f"{tuple(taus.shape)}, target {tuple(target.shape)}")
    if 4 * (n_target + 2 * n) > 48 * 1024:
        raise ValueError("K1 keeps a sample's targets and row sums in 48 KB of shared memory")
    if not kappa > 0:
        raise ValueError(f"K1 needs kappa > 0, got {kappa}")
    for t in (online, taus, target):
        if t.device != online.device or not t.is_contiguous():
            raise ValueError("K1 inputs must be contiguous on one device")
    loss = torch.empty((batch,), dtype=torch.float32, device=online.device)
    td_abs = torch.empty((batch,), dtype=torch.float32, device=online.device)
    grad = torch.empty((batch, n), dtype=torch.float32, device=online.device)
    with torch.cuda.device(online.device):
        code = _entry()(
            build.ptr(online), build.ptr(taus), build.ptr(target), build.ptr(loss),
            build.ptr(td_abs), build.ptr(grad), batch, n, n_target, float(kappa),
            build.stream_of(online.device))
    build.check_launch(NAME, code)
    return loss, td_abs, grad


class QuantileHuberFn(torch.autograd.Function):
    """(online, taus, target) -> (loss [B], td_abs [B]), differentiable in
    ``online`` only; ``td_abs`` (the priorities) carries no gradient."""

    @staticmethod
    def forward(ctx, online, taus, target, kappa):
        loss, td_abs, grad = quantile_huber(online, taus, target, kappa)
        ctx.save_for_backward(grad)
        ctx.mark_non_differentiable(td_abs)
        return loss, td_abs

    @staticmethod
    def backward(ctx, d_loss, d_td_abs):
        (grad,) = ctx.saved_tensors
        return d_loss[:, None] * grad, None, None, None
