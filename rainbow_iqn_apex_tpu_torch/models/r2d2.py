"""R2D2 recurrent Q-network, in PyTorch: conv trunk -> LSTM -> dueling noisy head.

Counterpart of ``rainbow_iqn_apex_tpu/models/r2d2.py`` ``R2D2Net``
(:50-122): the conv trunk over the folded [B*T] batch, phi cast to fp32, the
resettable LSTM over time in fp32, then dueling NoisyLinear value and
advantage heads with a scalar (not quantile) combine, q [B, T, A] fp32.

On CUDA the recurrence is K9 (``kernels/lstm.py``; its input projection
phi @ W_i is one plain product for all steps), the heads K3, and the
dueling combine with the greedy argmax K4 at one "tau" per row; K9-bwd,
K3-bwd and K4-bwd are the backward.  The combine is fp32 as in JAX: the
JAX NoisyLinear returns fp32 (fp32 accumulation plus fp32 bias), so
``value + adv - mean(adv)`` there is an fp32 expression, which is what K4
computes.

Parameters keep the JAX layouts where the LSTM is concerned: ``lstm.w_i``
[F, 4H] and ``lstm.w_h`` [H, 4H] are flax ``OptimizedLSTMCell``'s input
and recurrent kernels concatenated in its gate order i, f, g, o, and
``lstm.b`` [4H] its recurrent biases (the input kernels have none).

The recurrent state is an explicit (c, h) pair the caller owns; noise is an
explicit argument (or drawn from a given ``torch.Generator``), never module
state.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import DuelingGatherFn, dueling_head
from rainbow_iqn_apex_tpu_torch.kernels.lstm import LSTMFn, lstm_forward
from rainbow_iqn_apex_tpu_torch.models.layers import ConvTrunk, NoisyLinear, trunk_features

LSTMState = Tuple[torch.Tensor, torch.Tensor]  # (c, h), each [B, lstm_size] fp32
Noise = Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]


class ResettableLSTM(nn.Module):
    """The LSTM of ``R2D2Net``: flax ``OptimizedLSTMCell`` parameters, scanned
    over time with a state reset before each step whose ``reset`` is set."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        self.w_i = nn.Parameter(torch.empty(in_features, 4 * features))
        self.w_h = nn.Parameter(torch.empty(features, 4 * features))
        self.b = nn.Parameter(torch.empty(4 * features))

    def forward(self, x: torch.Tensor, state: LSTMState,
                resets: torch.Tensor) -> Tuple[torch.Tensor, LSTMState]:
        """x [B, T, F] fp32, resets [B, T] bool -> (h_seq [B, T, H], (c, h))."""
        batch, steps, feat = x.shape
        xw = (x.reshape(batch * steps, feat) @ self.w_i).reshape(batch, steps, -1)
        c0, h0 = (s.contiguous() for s in state)
        resets = resets.contiguous()
        if torch.is_grad_enabled() and self.w_h.requires_grad:
            h_seq, c, h = LSTMFn.apply(xw, self.w_h, self.b, resets, c0, h0)
        else:
            h_seq, c, h, _ = lstm_forward(xw, self.w_h, self.b, resets, c0, h0)
        return h_seq, (c, h)


class R2D2Net(nn.Module):
    """Recurrent dueling noisy Q-network over frame sequences.

    ``net(obs_seq, state, resets=None, noise=None, generator=None, noisy=None)
    -> (q [B, T, A] fp32, final state)``; ``obs_seq`` is [B, T, H, W, C]
    uint8 (or float in [0, 1]), NHWC per step as in JAX.
    """

    def __init__(self, num_actions: int, state_shape: Tuple[int, int, int],
                 lstm_size: int = 512, hidden_size: int = 512, noisy_sigma0: float = 0.5,
                 dueling: bool = True, use_noise: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        height, width, channels = state_shape
        feat = trunk_features(height, width)
        self.num_actions = num_actions
        self.lstm_size = lstm_size
        self.dueling = dueling
        self.use_noise = use_noise
        self.compute_dtype = compute_dtype
        self.inv255 = float(torch.tensor(1.0 / 255.0, dtype=compute_dtype))
        self.trunk = ConvTrunk(channels, compute_dtype)
        self.lstm = ResettableLSTM(feat, lstm_size)
        heads = ("value", "advantage") if dueling else ("q",)
        for name in heads:
            out_dim = 1 if name == "value" else num_actions
            setattr(self, f"{name}_hidden",
                    NoisyLinear(lstm_size, hidden_size, noisy_sigma0, compute_dtype))
            setattr(self, f"{name}_out",
                    NoisyLinear(hidden_size, out_dim, noisy_sigma0, compute_dtype))
        self.noisy_names = tuple(f"{h}_{part}" for h in heads for part in ("hidden", "out"))

    def initial_state(self, batch: int, device=None) -> LSTMState:
        device = device if device is not None else self.lstm.w_h.device
        z = torch.zeros((batch, self.lstm_size), dtype=torch.float32, device=device)
        return z, z.clone()

    def sample_noise(self, generator: Optional[torch.Generator]) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        return {name: getattr(self, name).sample_noise(generator) for name in self.noisy_names}

    def features(self, obs_seq: torch.Tensor, state: LSTMState,
                 resets: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, LSTMState]:
        """Trunk and LSTM: (h_seq [B, T, lstm_size] fp32, final state)."""
        batch, steps = obs_seq.shape[:2]
        if obs_seq.dtype == torch.uint8:
            obs_seq = obs_seq.to(self.compute_dtype) * self.inv255
        phi = self.trunk(obs_seq.reshape(batch * steps, *obs_seq.shape[2:]))
        phi = phi.reshape(batch, steps, -1).float()  # the LSTM runs in fp32
        if resets is None:
            resets = torch.zeros((batch, steps), dtype=torch.bool, device=obs_seq.device)
        return self.lstm(phi, state, resets)

    def heads(self, feat: torch.Tensor, noise: Noise = None,
              generator: Optional[torch.Generator] = None, noisy: Optional[bool] = None):
        """K3 heads over feat [N, lstm_size]: (value [N, 1] or None, adv [N, A])."""
        use_noise = self.use_noise if noisy is None else noisy
        if use_noise and noise is None:
            noise = self.sample_noise(generator)
        eps = noise if use_noise else {}

        def head(name: str) -> torch.Tensor:
            hidden = getattr(self, f"{name}_hidden")(feat, eps.get(f"{name}_hidden"), relu=True)
            return getattr(self, f"{name}_out")(hidden, eps.get(f"{name}_out"))

        if self.dueling:
            return head("value"), head("advantage")
        return None, head("q")

    def step(self, obs_seq: torch.Tensor, state: LSTMState,
             resets: Optional[torch.Tensor] = None, noise: Noise = None,
             generator: Optional[torch.Generator] = None, noisy: Optional[bool] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor, LSTMState]:
        """The forward with K4's greedy argmax: (q [B, T, A], action [B, T]
        int32, final state)."""
        batch, steps = obs_seq.shape[:2]
        feat, final = self.features(obs_seq, state, resets)
        value, adv = self.heads(feat.reshape(batch * steps, -1), noise, generator, noisy)
        _, q, action = dueling_head(value, adv, 1)  # K4 at one tau per row
        return (q.reshape(batch, steps, self.num_actions), action.reshape(batch, steps), final)

    def forward(self, obs_seq: torch.Tensor, state: LSTMState,
                resets: Optional[torch.Tensor] = None, noise: Noise = None,
                generator: Optional[torch.Generator] = None,
                noisy: Optional[bool] = None) -> Tuple[torch.Tensor, LSTMState]:
        q, _, final = self.step(obs_seq, state, resets, noise, generator, noisy)
        return q, final

    def gather(self, feat: torch.Tensor, actions: torch.Tensor, noise: Noise = None,
               generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The heads on feat [N, lstm_size] gathered at ``actions`` [N] int32:
        (q_taken [N], q [N, A]); q_taken is differentiable (K4 gather +
        K4-bwd), q is not.  The learner's ``take_along_axis``."""
        value, adv = self.heads(feat, noise, generator)
        z, q = DuelingGatherFn.apply(value, adv, actions, 1)
        return z[:, 0], q


def make_r2d2_network(cfg, num_actions: int, use_noise: bool = True,
                      state_shape: Optional[Tuple[int, int, int]] = None) -> R2D2Net:
    """The port's ``R2D2Net`` for ``cfg`` (counterpart of JAX
    ``ops/r2d2.py:make_r2d2_network``); parameters uninitialised, fp32, CPU."""
    return R2D2Net(
        num_actions=num_actions,
        state_shape=tuple(state_shape or cfg.state_shape),
        lstm_size=cfg.lstm_size,
        hidden_size=cfg.hidden_size,
        noisy_sigma0=cfg.noisy_sigma0,
        dueling=cfg.dueling,
        use_noise=use_noise,
        compute_dtype=getattr(torch, cfg.compute_dtype),
    )
