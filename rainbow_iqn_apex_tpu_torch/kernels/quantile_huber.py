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
no backward pass goes over the pairs again.  Taus and targets get no
gradient (the targets are under ``stop_gradient`` in the JAX learner).

Two modes of one kernel (``csrc/quantile_huber.cu``):

- per-sample (``quantile_huber``): (loss [B], td_abs [B], grad [B, N]);
  ``QuantileHuberFn`` is its autograd function, whose backward scales grad
  by the upstream cotangent, an elementwise torch op;
- weighted (``quantile_huber_weighted``), the learn step's: the same and the
  IS-weighted mean, mean_b(w * loss_b) with w = weight (* weight_scale, the
  reuse passes' clipped ratio, formed first), ``rainbow_iqn_apex_tpu/ops/
  learn.py:158-162``.  ``kernels/learn_loss.py`` chains it with K4's heads
  mode and K4-bwd's loss mode.  Given a ``replay_writeback.Writeback``
  target (the fused Anakin step's device ring and draws), the same launch
  also does K6's fenced write-back of its td_abs into the ring, so the step
  launches no K6; the twin runs K1's, then K6's.

Bound on the H100: ~24 KB of inputs at B = 32, N = N' = 64, under 0.1 us of
bytes or flops, so the launch is the cost.  ``loss_plan`` gives the launch:
one thread-block cluster of up to 16 blocks, ceil(B / 16) samples a block,
block 0 summing the mean in a fixed order through distributed shared
memory, so two calls on one input give equal bits and nothing persists
between launches.  The per-sample mode runs one sample a block.

``quantile_huber`` and ``quantile_huber_weighted`` run the kernel for CUDA
tensors and ``quantile_huber_plain`` / ``quantile_huber_weighted_plain``
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build
from rainbow_iqn_apex_tpu_torch.kernels.replay_writeback import (
    NAME as K6_NAME,
    Writeback,
    replay_writeback_plain,
)

NAME = "K1_quantile_huber"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/quantile_huber.cu"
REPLACES = "rainbow_iqn_apex_tpu/ops/losses.py:31"
MAX_CLUSTER = 16  # blocks of the weighted mode's cluster (above 8: the non-portable size)
SMEM_LIMIT = 225 * 1024  # a block's dynamic shared memory, with the opt-in (csrc: kMaxShared)


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


def loss_plan(batch: int, n: int, n_target: int, fold: bool = False) -> int:
    """Samples a block of K1's weighted mode: ceil(B / 16), so its
    ceil(B / S) blocks make one cluster of at most 16.  Raises where a
    block's inputs and row sums, with the batch's w * loss in block 0 (and,
    with K6 folded in, its td_abs and ids), pass the shared memory a block
    can take."""
    if batch < 1 or n < 1 or n_target < 1:
        raise ValueError(f"K1 takes B, N, N' >= 1, got {batch}, {n}, {n_target}")
    samples = -(-batch // MAX_CLUSTER)
    if 4 * (samples * (n_target + 4 * n) + batch * (3 if fold else 1)) > SMEM_LIMIT:
        raise ValueError(f"K1 keeps {samples} samples' targets, quantiles, taus and row sums in "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return samples


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_quantile_huber
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_writeback(wb: Writeback, batch: int, device: torch.device) -> int:
    """The groups of a fold's write-back target, or a raise."""
    if wb.idx.dim() != 2 or wb.idx.numel() != batch:
        raise ValueError(f"K6 in K1 takes idx [G, B / G] over the batch of {batch}, got "
                         f"{tuple(wb.idx.shape)}")
    groups, per_group = wb.idx.shape
    if not 1 <= per_group <= 1024:
        raise ValueError(f"K6 in K1 writes 1 <= B / G <= 1024 draws a group, got {per_group}")
    if (wb.priority.dtype, wb.max_priority.dtype, wb.idx.dtype) != (
            torch.float32, torch.float32, torch.int32):
        raise TypeError("K6 in K1 takes fp32 priorities and max_priority, int32 idx")
    if wb.priority.dim() != 1 or wb.max_priority.dim() != 0:
        raise ValueError("K6 in K1 takes priority [N] and max_priority []")
    for t in wb[:3]:
        if t.device != device or not t.is_contiguous():
            raise ValueError("K6 in K1: the ring and ids must be contiguous on the loss's device")
    return groups


def _launch(online, taus, target, kappa, weight, weight_scale, writeback=None):
    """Checks and one launch of K1 (with K6 folded in where ``writeback``
    is given); returns (per_sample, td_abs, grad, mean or None)."""
    batch, n = online.shape
    n_target = target.shape[1]
    if any(t.dtype != torch.float32 for t in (online, taus, target)):
        raise TypeError("K1 takes fp32 online quantiles, taus and targets")
    if tuple(taus.shape) != (batch, n) or target.shape[0] != batch:
        raise ValueError(f"K1 shape mismatch: online {tuple(online.shape)}, taus "
                         f"{tuple(taus.shape)}, target {tuple(target.shape)}")
    if not kappa > 0:
        raise ValueError(f"K1 needs kappa > 0, got {kappa}")
    weights = [t for t in (weight, weight_scale) if t is not None]
    for t in weights:
        if t.dtype != torch.float32 or tuple(t.shape) != (batch,):
            raise ValueError(f"K1 takes fp32 weights [{batch}], got {t.dtype} {tuple(t.shape)}")
    for t in (online, taus, target, *weights):
        if t.device != online.device or not t.is_contiguous():
            raise ValueError("K1 inputs must be contiguous on one device")
    groups = 0 if writeback is None else _check_writeback(writeback, batch, online.device)
    samples = 1 if weight is None else loss_plan(batch, n, n_target, writeback is not None)
    dev = online.device
    per_sample = torch.empty((batch,), dtype=torch.float32, device=dev)
    td_abs = torch.empty((batch,), dtype=torch.float32, device=dev)
    grad = torch.empty((batch, n), dtype=torch.float32, device=dev)
    mean = None if weight is None else torch.empty((), dtype=torch.float32, device=dev)
    p = build.ptr
    wb = writeback or Writeback(None, None, None, 0.0, 0.0)
    with torch.cuda.device(dev):
        code = _entry()(
            p(online), p(taus), p(target), p(weight), p(weight_scale), p(per_sample), p(td_abs),
            p(grad), p(mean), batch, n, n_target, samples, float(kappa), p(wb.priority),
            p(wb.max_priority), p(wb.idx), 0 if writeback is None else wb.priority.numel(),
            groups, float(wb.eps), float(wb.omega), build.stream_of(dev))
    build.check_launch(NAME, code, fold=None if writeback is None else K6_NAME)
    return per_sample, td_abs, grad, mean


def quantile_huber(online: torch.Tensor, taus: torch.Tensor, target: torch.Tensor,
                   kappa: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 on ``online.device``: the kernel on CUDA, the plain twin on the CPU."""
    if online.device.type == "cpu":
        return quantile_huber_plain(online, taus, target, kappa)
    return _launch(online, taus, target, kappa, None, None)[:3]


def quantile_huber_weighted_plain(online: torch.Tensor, taus: torch.Tensor,
                                  target: torch.Tensor, weight: torch.Tensor,
                                  weight_scale: Optional[torch.Tensor] = None,
                                  kappa: float = 1.0) -> Tuple[torch.Tensor, ...]:
    """K1's weighted mode in plain torch: (mean [], per_sample [B], td_abs
    [B], grad [B, N]) with mean = mean_b(w * per_sample), w = weight (times
    ``weight_scale``, formed first), as ``ops/learn.py:158-162`` of the JAX
    package composes it."""
    per_sample, td_abs, grad = quantile_huber_plain(online, taus, target, kappa)
    w = weight if weight_scale is None else weight * weight_scale
    return torch.mean(w * per_sample), per_sample, td_abs, grad


def quantile_huber_weighted(online: torch.Tensor, taus: torch.Tensor, target: torch.Tensor,
                            weight: torch.Tensor, weight_scale: Optional[torch.Tensor] = None,
                            kappa: float = 1.0, writeback: Optional[Writeback] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """K1's weighted mode on ``online.device``: one launch on CUDA (one
    cluster of blocks), the plain twin on the CPU.  ``writeback``: K6's
    write-back of td_abs into that ring too, in the same launch on CUDA; on
    the CPU K1's twin, then K6's."""
    if online.device.type == "cpu":
        out = quantile_huber_weighted_plain(online, taus, target, weight, weight_scale, kappa)
        if writeback is not None:
            replay_writeback_plain(writeback.priority, writeback.max_priority, writeback.idx,
                                   out[2], writeback.eps, writeback.omega)
        return out
    per_sample, td_abs, grad, mean = _launch(online, taus, target, kappa, weight, weight_scale,
                                             writeback)
    return mean, per_sample, td_abs, grad


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
