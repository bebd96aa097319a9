"""Dueling noisy-net IQN Q-network, in PyTorch: the port's flagship model.

Counterpart of ``rainbow_iqn_apex_tpu/models/iqn.py`` ``RainbowIQN``:
conv trunk -> phi(s); tau ~ U[0, 1) -> 64-cosine embedding -> psi(tau);
Hadamard phi * psi folded to [B*N, F]; dueling NoisyLinear value/advantage
heads; Z_tau(s, a) per sampled tau.  The forward runs through the port's
kernels: K2 (embedding + merge), K3 (the four NoisyLinear GEMMs) and K4 (the
dueling combine with the tau-mean and the greedy argmax).  The learner's
``heads`` runs the same network up to K4, differentiably, and hands its
three heads to one launch of K4's heads mode (ops/learn.py): K2-bwd, K3-bwd
and K4-bwd are the backward.

The bf16 rounding points are the JAX model's: obs * (1/255), the conv
outputs, the cos features, the embedding and its bias add and phi * psi
round to the compute dtype; the heads accumulate in fp32 with fp32 biases;
the hidden ReLU output is fp32; the dueling combine is fp32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import dueling_head, dueling_logp
from rainbow_iqn_apex_tpu_torch.models.layers import (
    ConvTrunk,
    CosineTauEmbedding,
    NoisyLinear,
    trunk_features,
)


class IQNOutput(NamedTuple):
    quantiles: torch.Tensor  # [B, N, A] fp32 quantile values Z_tau(s, a)
    taus: torch.Tensor  # [B, N] fp32 quantile fractions
    q: torch.Tensor  # [B, A] fp32 mean over taus
    action: torch.Tensor  # [B] int32 greedy action, first index on ties


class RainbowIQN(nn.Module):
    """Implicit Quantile Network with dueling + noisy heads.

    ``net(obs, num_taus, taus=None, generator=None, noise=None)``

    obs:    [B, H, W, C] uint8 (or float already in [0, 1]), NHWC as in JAX
    taus:   [B, num_taus] fp32 to override the draw (tests), else drawn from
            ``generator`` as U[0, 1)
    noise:  with ``use_noise``, a dict layer name -> (eps_in, eps_out)
            standard normals to override the draw (tests), else drawn from
            ``generator`` per NoisyLinear per call
    noisy:  overrides ``use_noise`` for this call (the learner's module
            acts with noise off at evaluation)
    """

    def __init__(self, num_actions: int, state_shape: Tuple[int, int, int],
                 hidden_size: int = 512, num_cosines: int = 64,
                 noisy_sigma0: float = 0.5, dueling: bool = True,
                 use_noise: bool = True, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        height, width, channels = state_shape
        feat = trunk_features(height, width)
        self.num_actions = num_actions
        self.dueling = dueling
        self.use_noise = use_noise
        self.compute_dtype = compute_dtype
        # 1/255 rounded to the compute dtype, as JAX rounds the weak scalar
        self.inv255 = float(torch.tensor(1.0 / 255.0, dtype=compute_dtype))
        self.trunk = ConvTrunk(channels, compute_dtype)
        self.tau_embed = CosineTauEmbedding(feat, num_cosines, compute_dtype)
        heads = ("value", "advantage") if dueling else ("q",)
        for name in heads:
            out_dim = 1 if name == "value" else num_actions
            setattr(self, f"{name}_hidden",
                    NoisyLinear(feat, hidden_size, noisy_sigma0, compute_dtype))
            setattr(self, f"{name}_out",
                    NoisyLinear(hidden_size, out_dim, noisy_sigma0, compute_dtype))
        self.noisy_names = tuple(f"{h}_{part}" for h in heads for part in ("hidden", "out"))

    def cast_for_inference_(self) -> "RainbowIQN":
        """Store in the compute dtype every parameter that the forward only
        reads cast to it: the conv weights and biases, the embedding weight
        and the NoisyLinear weights.  The per-call casts become no-ops and
        the numbers do not change.  In place; returns self."""
        cdt = self.compute_dtype
        params = [*self.trunk.parameters(), self.tau_embed.embed.weight]
        for name in self.noisy_names:
            layer = getattr(self, name)
            params += [layer.w_mu, layer.w_sigma]
        for p in params:
            p.data = p.data.to(cdt)
        return self

    def sample_noise(self, generator: Optional[torch.Generator]) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        return {name: getattr(self, name).sample_noise(generator) for name in self.noisy_names}

    def _merge(self, taus: torch.Tensor, phi: torch.Tensor,
               game: Optional[torch.Tensor]) -> torch.Tensor:
        """K2: the tau embedding merged with phi, [B*N, F]."""
        if game is not None:
            raise ValueError("game ids need the multi-game network (multitask.MultiGameIQN)")
        return self.tau_embed(taus, phi)

    def _combine(self, value: Optional[torch.Tensor], adv: torch.Tensor, num_taus: int,
                 game: Optional[torch.Tensor]):
        """K4: (quantiles, q, action)."""
        return dueling_head(value, adv, num_taus)

    def _heads(self, obs: torch.Tensor, num_taus: int, taus: Optional[torch.Tensor],
               generator: Optional[torch.Generator],
               noise: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]],
               noisy: Optional[bool], game: Optional[torch.Tensor] = None):
        """Trunk, K2 and the K3 heads: (value [B*N, 1] or None, adv [B*N, A], taus).
        Draws taus, then each layer's noise, from ``generator``."""
        batch = obs.shape[0]
        if obs.dtype == torch.uint8:
            obs = obs.to(self.compute_dtype) * self.inv255
        phi = self.trunk(obs)  # [B, F]
        if taus is None:
            taus = torch.rand((batch, num_taus), generator=generator, device=obs.device)
        h = self._merge(taus, phi, game)  # K2 (K2g): [B*N, F]
        use_noise = self.use_noise if noisy is None else noisy
        if use_noise and noise is None:
            noise = self.sample_noise(generator)
        eps = noise if use_noise else {}

        def head(name: str) -> torch.Tensor:
            hidden = getattr(self, f"{name}_hidden")(h, eps.get(f"{name}_hidden"), relu=True)
            return getattr(self, f"{name}_out")(hidden, eps.get(f"{name}_out"))

        if self.dueling:
            return head("value"), head("advantage"), taus
        return None, head("q"), taus

    def forward(self, obs: torch.Tensor, num_taus: int,
                taus: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
                noisy: Optional[bool] = None, game: Optional[torch.Tensor] = None) -> IQNOutput:
        value, adv, taus = self._heads(obs, num_taus, taus, generator, noise, noisy, game)
        quantiles, q, action = self._combine(value, adv, num_taus, game)  # K4 (K4m)
        return IQNOutput(quantiles, taus, q, action)

    def heads(self, obs: torch.Tensor, num_taus: int, taus: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              noise: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
              game: Optional[torch.Tensor] = None) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                                                            torch.Tensor]:
        """The forward up to K4: (value [B*N, 1] or None, adv [B*N, A], taus
        [B, N]), differentiable in the parameters.  The learner hands its
        three heads to K4's heads mode (ops/learn.py)."""
        return self._heads(obs, num_taus, taus, generator, noise, None, game)

    def logp(self, obs: torch.Tensor, num_taus: int, actions: torch.Tensor,
             taus: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
             game: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B] log-prob of ``actions`` under softmax of the tau-mean q (K4l;
        masked to each row's game in the multi-game network), detached:
        ``make_policy_logp`` of ``rainbow_iqn_apex_tpu/ops/learn.py``."""
        with torch.no_grad():
            value, adv, _ = self._heads(obs, num_taus, taus, generator, noise, None, game)
            return dueling_logp(value, adv, num_taus, actions, *self.mask_args(game))[0]

    def mask_args(self, game: Optional[torch.Tensor]) -> tuple:
        """(game, mask) for the K4 modes that mask, () without a mask."""
        return ()


def q_values(quantiles: torch.Tensor) -> torch.Tensor:
    """Mean over the tau dimension: [B, N, A] -> [B, A] expected Q."""
    return quantiles.mean(dim=1)


def greedy_action(quantiles: torch.Tensor) -> torch.Tensor:
    """Greedy action from quantile means: [B, N, A] -> [B] int32."""
    return torch.argmax(q_values(quantiles), dim=-1).to(torch.int32)
