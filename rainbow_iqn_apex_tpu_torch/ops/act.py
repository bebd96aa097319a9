"""Batched acting: the IQN forward the policy server dispatches.

Counterpart of ``rainbow_iqn_apex_tpu/ops/learn.py`` ``build_act_step``
(:321-341): mean over K = ``cfg.num_quantile_samples`` taus, argmax; taus
drawn per call, and in noisy mode eps per NoisyLinear per call, from an
explicit ``torch.Generator``.  On CUDA every step of the forward after the
convolutions is one of the port's kernels (K2, K3 x4, K4; on quantized
weights K10d, K2, K10g x4, K4).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Mapping, Optional, Tuple, Union

import torch

from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.models.init import make_network
from rainbow_iqn_apex_tpu_torch.models.iqn import RainbowIQN

if TYPE_CHECKING:
    from rainbow_iqn_apex_tpu_torch.models.quantized import QuantizedIQN

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda:0`` unless the caller names a device.  Without CUDA the caller
    must ask for the CPU explicitly: there is no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on cuda:0 unless the "
                "caller passes device='cpu'")
        return torch.device("cuda", 0)
    return torch.device(device)


def load_network(cfg: Config, num_actions: int, params: Mapping[str, torch.Tensor],
                 device: torch.device, use_noise: bool = True,
                 state_shape: Optional[Tuple[int, int, int]] = None) -> RainbowIQN:
    """A ``RainbowIQN`` on ``device`` holding ``params`` (the port's state
    dict, e.g. from ``models.init_params`` or ``convert.from_flax``), cast
    for inference and with gradients off."""
    net = make_network(cfg, num_actions, use_noise=use_noise, state_shape=state_shape)
    net.load_state_dict(params)
    net.to(device).cast_for_inference_()
    return net.requires_grad_(False).eval()


ActStep = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def build_act_step(cfg: Config, num_actions: int, use_noise: bool = True) -> ActStep:
    """Batched greedy acting: (net, obs [B, H, W, C] u8, generator) ->
    (actions [B] int32, q [B, A] fp32), both on the net's device.  ``net``
    is the params holder: a network from ``load_network``, or a
    ``models.quantized.QuantizedIQN`` (the JAX package's
    ``wrap_act_quantized(act_step)``: the same step on quantized weights,
    through K10d and K10g).  ``taus=`` and ``noise=`` replace the
    generator's draws (tests)."""

    def act_step(net: Union[RainbowIQN, "QuantizedIQN"], obs: torch.Tensor,
                 generator: Optional[torch.Generator],
                 taus: Optional[torch.Tensor] = None,
                 noise=None) -> Tuple[torch.Tensor, torch.Tensor]:
        if net.use_noise != use_noise or net.num_actions != num_actions:
            raise ValueError("act step and network disagree on noise or actions")
        with torch.inference_mode():
            out = net(obs, cfg.num_quantile_samples, taus=taus, generator=generator,
                      noise=noise)
        return out.action, out.q

    return act_step
