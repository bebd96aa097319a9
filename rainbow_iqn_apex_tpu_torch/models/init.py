"""Seeded parameter initialisation with the JAX model's distributions.

Counterpart of the params half of ``rainbow_iqn_apex_tpu/ops/learn.py``
``init_train_state`` (:80), which runs flax's initialisers:

- conv and Dense kernels: lecun-normal, a normal of variance 1/fan_in
  truncated at two standard deviations (flax's ``variance_scaling(1.0,
  "fan_in", "truncated_normal")``); zero biases;
- NoisyLinear: mu ~ U(-1/sqrt(in), 1/sqrt(in)) for weight and bias, and
  sigma = sigma0 / sqrt(in) for weight and bias;
- R2D2's LSTM (flax ``OptimizedLSTMCell``): each gate's input kernel
  lecun-normal, each gate's recurrent kernel orthogonal, zero biases.

The distributions are the same; the bits are not (JAX and torch generators
differ).  Tests that need both frameworks on one model go through
``convert.py`` instead.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.models.iqn import RainbowIQN
from rainbow_iqn_apex_tpu_torch.models.layers import NoisyLinear
from rainbow_iqn_apex_tpu_torch.models.r2d2 import ResettableLSTM

# stddev of a unit normal truncated to (-2, 2): flax rescales by it
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_network_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter of ``net`` (a ``RainbowIQN`` or an
    ``R2D2Net``) in place; returns ``net``."""
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, nn.Conv2d):
                _lecun_normal_(module.weight, module.weight[0].numel(), generator)
                module.bias.zero_()
            elif isinstance(module, nn.Linear):
                _lecun_normal_(module.weight, module.in_features, generator)
                module.bias.zero_()
            elif isinstance(module, NoisyLinear):
                bound = 1.0 / module.in_features ** 0.5
                module.w_mu.uniform_(-bound, bound, generator=generator)
                module.b_mu.uniform_(-bound, bound, generator=generator)
                module.w_sigma.fill_(module.sigma0 * bound)
                module.b_sigma.fill_(module.sigma0 * bound)
            elif isinstance(module, ResettableLSTM):
                _lecun_normal_(module.w_i, module.w_i.shape[0], generator)
                for gate in module.w_h.split(module.features, dim=1):
                    gate.copy_(nn.init.orthogonal_(torch.empty_like(gate), generator=generator))
                module.b.zero_()
    return net


def make_network(cfg: Config, num_actions: int, use_noise: bool = True,
                 state_shape: Optional[Tuple[int, int, int]] = None) -> RainbowIQN:
    """The port's ``RainbowIQN`` for ``cfg`` (counterpart of
    ``ops/learn.py:68`` ``make_network``); parameters uninitialised, fp32,
    on the CPU."""
    return RainbowIQN(
        num_actions=num_actions,
        state_shape=tuple(state_shape or cfg.state_shape),
        hidden_size=cfg.hidden_size,
        num_cosines=cfg.num_cosines,
        noisy_sigma0=cfg.noisy_sigma0,
        dueling=cfg.dueling,
        use_noise=use_noise,
        compute_dtype=getattr(torch, cfg.compute_dtype),
    )


def init_params(cfg: Config, num_actions: int, seed: int,
                state_shape: Optional[Tuple[int, int, int]] = None) -> Dict[str, torch.Tensor]:
    """Fresh fp32 parameters on the CPU, as a state dict, from ``seed``."""
    generator = torch.Generator().manual_seed(seed)
    net = init_network_(make_network(cfg, num_actions, state_shape=state_shape), generator)
    return {k: v.detach().clone() for k, v in net.state_dict().items()}
