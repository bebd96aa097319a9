"""Task-conditioned act and learn steps: ``ops/learn.py`` with game ids.

Counterpart of ``rainbow_iqn_apex_tpu/multitask/ops.py``.  The learn step is
the port's ``build_learn_step`` itself: on a ``MultiGameIQN`` state with
``Batch.game`` set, every forward adds the game embedding (K2g), the
double-Q a* is masked to each row's game (K4m), and with ``replay_ratio`` >
1 the reuse ratio's log-softmax is masked too (K4l), which is what the loss
function and the masked ``logp`` of the JAX ``build_mt_learn_step`` do.  The
act step returns the masked q, so the actor-side priority estimator's max
stays inside each row's action set.
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.models.init import init_network_
from rainbow_iqn_apex_tpu_torch.multitask.model import MultiGameIQN
from rainbow_iqn_apex_tpu_torch.multitask.spec import MultiGameSpec
from rainbow_iqn_apex_tpu_torch.ops.act import DeviceLike, resolve_device
from rainbow_iqn_apex_tpu_torch.ops.learn import (
    TrainState,
    build_learn_step,
    check_supported,
    make_optimizer,
)


def action_mask_table(spec: MultiGameSpec) -> np.ndarray:
    """[G, max_actions] bool: True where the action id is real for the game."""
    table = np.zeros((spec.num_games, spec.max_actions), bool)
    for g, n in enumerate(spec.num_actions):
        table[g, :n] = True
    return table


def make_mt_network(cfg: Config, spec: MultiGameSpec, use_noise: bool = True) -> MultiGameIQN:
    """The port's ``MultiGameIQN`` for ``cfg`` and ``spec`` (suite-common
    frame, ``max_actions`` outputs); parameters uninitialised, fp32, on the
    CPU."""
    return MultiGameIQN(
        num_games=spec.num_games,
        num_actions=spec.max_actions,
        state_shape=(*spec.frame_shape, cfg.history_length),
        mask_table=action_mask_table(spec),
        hidden_size=cfg.hidden_size,
        num_cosines=cfg.num_cosines,
        noisy_sigma0=cfg.noisy_sigma0,
        dueling=cfg.dueling,
        use_noise=use_noise,
        compute_dtype=getattr(torch, cfg.compute_dtype),
    )


def init_mt_train_state(cfg: Config, spec: MultiGameSpec, seed: int,
                        device: DeviceLike = None) -> TrainState:
    """Fresh TrainState over ``MultiGameIQN`` on ``device`` (``cuda:0``
    unless named): params from ``seed`` as ``init_train_state`` draws them,
    the game embedding zero, target = a copy, Adam moments zero."""
    check_supported(cfg)
    device = resolve_device(device)
    net = make_mt_network(cfg, spec)
    init_network_(net, torch.Generator().manual_seed(int(seed)))
    net.to(device)
    target = copy.deepcopy(net).requires_grad_(False)
    return TrainState(net=net, target=target, optimizer=make_optimizer(cfg, net.parameters()))


def build_mt_learn_step(cfg: Config, spec: MultiGameSpec):
    """The task-conditioned learn step ``(state, batch, generator=None,
    draws=None) -> (state, info)`` (``batch.game`` set); ``replay_ratio`` >
    1 returns the reuse step with the masked log-probs."""
    return build_learn_step(cfg, spec.max_actions)


def load_mt_network(cfg: Config, spec: MultiGameSpec, params: Mapping[str, torch.Tensor],
                    device: torch.device, use_noise: bool = True) -> MultiGameIQN:
    """A ``MultiGameIQN`` on ``device`` holding ``params``, cast for
    inference (the game embedding stays fp32) and with gradients off."""
    net = make_mt_network(cfg, spec, use_noise=use_noise)
    net.load_state_dict(params)
    net.to(device).cast_for_inference_()
    return net.requires_grad_(False).eval()


def build_mt_act_step(cfg: Config, spec: MultiGameSpec, use_noise: bool = True):
    """Batched task-conditioned greedy acting: (net, obs [B, H, W, C] u8,
    game [B] int32, generator) -> (actions [B] int32, q [B, A] fp32 with
    MASK_FILL outside each row's game).  ``taus=`` and ``noise=`` replace
    the generator's draws (tests)."""

    def act_step(net: MultiGameIQN, obs: torch.Tensor, game: torch.Tensor,
                 generator: Optional[torch.Generator], taus: Optional[torch.Tensor] = None,
                 noise=None) -> Tuple[torch.Tensor, torch.Tensor]:
        if net.use_noise != use_noise or net.num_actions != spec.max_actions:
            raise ValueError("act step and network disagree on noise or actions")
        with torch.inference_mode():
            out = net(obs, cfg.num_quantile_samples, taus=taus, generator=generator,
                      noise=noise, game=game)
        return out.action, out.q

    return act_step
