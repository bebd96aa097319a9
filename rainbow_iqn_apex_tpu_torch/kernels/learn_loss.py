"""The learn step's loss chain: K4's heads launch, K1's weighted mode and,
backward, K4-bwd's loss mode, as one ``torch.autograd.Function``.

Counterpart of ``rainbow_iqn_apex_tpu/ops/learn.py:125-162``: from the three
heads (the double-Q select head, the target head, the online head) to

    loss = mean_b(w_b * per_sample_b),   w = weight (* weight_scale)

with ``per_sample`` and ``td_abs`` from the quantile-Huber loss (K1) of the
online quantiles at the taken actions against td_target.  On CUDA the
forward is two launches (``dueling_learn``, then
``quantile_huber_weighted``) and the backward one (``dueling_loss_bwd``,
which reads the loss's cotangent from the device), where torch's own chain
of the weighted mean and its backward took eight device ops besides.  On
the CPU every step runs its plain twin, in the order of that chain.

Only ``loss`` carries a gradient, to the online head's value and advantage;
``per_sample``, ``td_abs``, ``on_q`` and ``z_next`` carry none, and no
zeros are made for their cotangents.

``writeback`` (the fused Anakin step's device ring and draws,
``replay_writeback.Writeback``) has K1's launch write td_abs back into the
ring as K6 would (on the CPU: K6's twin after K1's).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import (
    Head,
    dueling_learn,
    dueling_loss_bwd,
)
from rainbow_iqn_apex_tpu_torch.kernels.quantile_huber import quantile_huber_weighted
from rainbow_iqn_apex_tpu_torch.kernels.replay_writeback import Writeback


class LearnLossFn(torch.autograd.Function):
    """(on_value, on_adv, take, num_online, select, target, reward, discount,
    game, mask, taus, weight, weight_scale, kappa, writeback) -> (loss [],
    per_sample [B], td_abs [B], on_q [B, A], z_next [B, N']), differentiable
    in on_value and on_adv through loss alone; ``select`` and ``target`` are
    (value, adv, taus) heads that carry no gradient, ``taus`` [B, N] the
    online head's, ``weight_scale`` [B] or None, ``writeback`` a
    ``Writeback`` or None."""

    @staticmethod
    def forward(ctx, on_value, on_adv, take, num_online, select, target, reward, discount,
                game, mask, taus, weight, weight_scale, kappa, writeback):
        z_online, on_q, _, z_next, td_target = dueling_learn(
            select, target, (on_value, on_adv, num_online), take, reward, discount, game, mask)
        loss, per_sample, td_abs, grad = quantile_huber_weighted(
            z_online, taus, td_target, weight, weight_scale, kappa, writeback)
        ctx.save_for_backward(take, weight, weight_scale, grad)
        ctx.dueling = on_value is not None
        ctx.num_actions = on_adv.shape[1]
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(per_sample, td_abs, on_q, z_next)
        return loss, per_sample, td_abs, on_q, z_next

    @staticmethod
    def backward(ctx, d_loss, *unused):
        none = (None,) * 13
        if d_loss is None:
            return (None, None, *none)
        take, weight, weight_scale, grad = ctx.saved_tensors
        dvalue, dadv = dueling_loss_bwd(d_loss.contiguous(), weight, weight_scale, grad, take,
                                        ctx.num_actions, ctx.dueling)
        return (dvalue, dadv, *none)


def learn_loss(online: Head, take: torch.Tensor, select: Head, target: Head,
               reward: torch.Tensor, discount: torch.Tensor, taus: torch.Tensor,
               weight: torch.Tensor, weight_scale: Optional[torch.Tensor], kappa: float,
               game: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
               writeback: Optional[Writeback] = None) -> Tuple[torch.Tensor, ...]:
    """``LearnLossFn`` over the online head (value, adv, N): (loss,
    per_sample, td_abs, on_q, z_next); ``writeback``: the priorities into
    that ring too."""
    on_value, on_adv, num_online = online
    return LearnLossFn.apply(on_value, on_adv, take, num_online, select, target,
                             reward.contiguous(), discount.contiguous(), game, mask,
                             taus.contiguous(), weight.contiguous(),
                             None if weight_scale is None else weight_scale.contiguous(),
                             float(kappa), writeback)
