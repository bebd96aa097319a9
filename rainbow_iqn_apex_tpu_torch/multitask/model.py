"""MultiGameIQN: the task-conditioned network of multi-game runs, in PyTorch.

Counterpart of ``rainbow_iqn_apex_tpu/multitask/model.py``: the port's
``RainbowIQN`` plus one parameter, a per-game embedding table added to the
conv torso's output before the tau merge,

    phi(s, g) = ConvTrunk(s) + E[g]          E in R^{G x F} fp32, E_0 = 0

and per-game action masks at greedy selection.  Zero init makes the forward
identical to the single-game ``RainbowIQN`` on the same trunk and head
parameters.  Shapes are game-invariant: frames padded to the suite-common
shape, the action dimension padded to ``max_actions``.

The embedding runs inside K2 (K2g: phi_g = bf16(phi + bf16(E[game])), the
JAX model's rounding at :89) and its gradient inside K2-bwd (K2g-bwd: dE).
The mask runs inside K4 (K4m: q set to ``MASK_FILL`` outside a row's game
before the argmax) for the act step and the double-Q a*, and inside K4l for
replay reuse's log-probs.  The quantiles themselves are never masked, so
the Q estimates of real actions are untouched; the learner's gathers (at a*
and at the taken action) are K4's heads mode, as JAX's ``take_along_axis``,
with the mask on the select head alone.

Call signature: ``net(obs, num_taus, taus=None, generator=None, noise=None,
noisy=None, game=game)`` with ``game`` [B] int32 game ids; the output's q is
masked and its action stays inside each row's game.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import MASK_FILL, dueling_head, mask_q
from rainbow_iqn_apex_tpu_torch.models.iqn import RainbowIQN, q_values

__all__ = ["MASK_FILL", "MultiGameIQN", "masked_greedy_action", "masked_q_values"]


class MultiGameIQN(RainbowIQN):
    """Task-conditioned dueling noisy-net IQN: ``RainbowIQN`` with
    ``game_embed`` [G, F] fp32 (zero at init) and the [G, A] action mask
    ``mask_table`` (a buffer, not a parameter: it is derived from the
    game list)."""

    def __init__(self, num_games: int, num_actions: int, state_shape: Tuple[int, int, int],
                 mask_table: Optional[np.ndarray] = None, **kwargs):
        super().__init__(num_actions, state_shape, **kwargs)
        self.num_games = int(num_games)
        feat = self.tau_embed.embed.weight.shape[0]
        self.game_embed = nn.Parameter(torch.zeros(num_games, feat))
        table = (np.ones((num_games, num_actions), bool) if mask_table is None
                 else np.asarray(mask_table, bool))
        if table.shape != (num_games, num_actions):
            raise ValueError(f"mask table {table.shape} != ({num_games}, {num_actions})")
        self.register_buffer("mask_table", torch.from_numpy(table.astype(np.uint8)),
                             persistent=False)

    def _merge(self, taus: torch.Tensor, phi: torch.Tensor,
               game: Optional[torch.Tensor]) -> torch.Tensor:
        if game is None:
            raise ValueError("MultiGameIQN needs the batch's game ids")
        return self.tau_embed(taus, phi, game, self.game_embed)  # K2g

    def _combine(self, value, adv, num_taus, game):
        return dueling_head(value, adv, num_taus, *self.mask_args(game))  # K4m

    def mask_args(self, game: Optional[torch.Tensor]) -> tuple:
        return (game.to(torch.int32).contiguous(), self.mask_table)


def masked_q_values(quantiles: torch.Tensor, game: torch.Tensor,
                    mask_table: torch.Tensor) -> torch.Tensor:
    """[B, N, A] -> [B, A] expected Q with each row's out-of-game action slots
    set to MASK_FILL (mask_table: [G, A] bool)."""
    return mask_q(q_values(quantiles), game, mask_table)


def masked_greedy_action(quantiles: torch.Tensor, game: torch.Tensor,
                         mask_table: torch.Tensor) -> torch.Tensor:
    """Greedy action restricted to each row's own game's action set, [B] int32."""
    return torch.argmax(masked_q_values(quantiles, game, mask_table), dim=-1).to(torch.int32)
