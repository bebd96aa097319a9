"""Quantile-regression losses of the port.

Counterpart of ``rainbow_iqn_apex_tpu/ops/losses.py``: the pairwise
quantile-Huber loss of IQN (Dabney et al. arXiv:1806.06923, eq. 3),

    u_ij   = td_target_j - online_quantile_i
    rho^k  = |tau_i - 1{u_ij < 0}| * Huber_k(u_ij) / k
    loss   = sum_i mean_j rho^k_ij        (per sample)

computed by K1 (``kernels/quantile_huber.py``): on CUDA one kernel that
never forms the [B, N, N'] pair tensor in device memory, on the CPU its
plain twin.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rainbow_iqn_apex_tpu_torch.kernels.quantile_huber import QuantileHuberFn


def huber(u: torch.Tensor, kappa: float) -> torch.Tensor:
    """Elementwise Huber_k(u): quadratic within |u| <= k, linear outside."""
    abs_u = torch.abs(u)
    return torch.where(abs_u <= kappa, 0.5 * u * u, kappa * (abs_u - 0.5 * kappa))


def quantile_huber_loss(
    online_quantiles: torch.Tensor,  # [B, N]   Z_tau_i(s, a)
    taus: torch.Tensor,  # [B, N]   online tau_i
    td_targets: torch.Tensor,  # [B, N']  r + gamma^n Z_tau'_j(s', a*)
    kappa: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise quantile-Huber loss: (per-sample loss [B], td_abs [B]).

    Differentiable in ``online_quantiles`` only (K1's backward); taus and
    targets get no gradient, and td_abs (the priority signal, mean |u_ij|)
    carries none."""
    return QuantileHuberFn.apply(online_quantiles.contiguous(), taus.contiguous(),
                                 td_targets.detach().contiguous(), float(kappa))
