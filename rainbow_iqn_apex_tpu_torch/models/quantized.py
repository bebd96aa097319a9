"""The act-only IQN on quantized weights: the port's ``wrap_act_quantized``.

Counterpart of ``rainbow_iqn_apex_tpu/utils/quantize.py``
``wrap_act_quantized`` (:239-247): the JAX package runs its unchanged act
step on ``dequantize_tree_jax(qparams)``, inside one XLA executable, so
every layer sees ``round(fp32(q) * s, compute dtype)`` weights (the
NoisyLinear biases stay fp32).  ``QuantizedIQN`` holds a
``QuantizedParams`` on the device and computes the same function through
the port's kernels:

    K10d   the conv weights and biases and the embedding weight and bias,
           dequantized into a scratch buffer in one launch
    convs  cuDNN on the scratch weights (``layers.conv_trunk``)
    K2     the tau embedding and the merge with phi, on the scratch
    K10g   the four NoisyLinear GEMMs on int8 / e4m3 weights
    K4     the dueling combine, the tau mean and the greedy argmax

K3 does not run.  It draws taus and noise from the generator as
``RainbowIQN`` does (taus, then each NoisyLinear's eps_in and eps_out in
``noisy_names`` order), takes the same ``taus=`` and ``noise=`` overrides,
and returns an ``IQNOutput``, so ``ops/act.py:build_act_step`` drives it as
it drives a ``RainbowIQN``.  Its q and s are its own buffers, never views
of a learner's parameters; ``load_`` copies new ones in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.kernels.dequantize import dequantize
from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import dueling_head
from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear_q import noisy_linear_q
from rainbow_iqn_apex_tpu_torch.kernels.tau_embed import tau_embed
from rainbow_iqn_apex_tpu_torch.models.iqn import IQNOutput
from rainbow_iqn_apex_tpu_torch.models.layers import CONV_SPECS, _f, conv_trunk
from rainbow_iqn_apex_tpu_torch.utils.quantize import QuantizedParams

Noise = Dict[str, Tuple[torch.Tensor, torch.Tensor]]

_EMBED = "tau_embed.embed"


class QuantizedIQN:
    """Act-only dueling noisy-net IQN on a ``QuantizedParams``.

    ``net(obs, num_taus, taus=None, generator=None, noise=None, noisy=None)``
    as ``RainbowIQN``.
    """

    def __init__(self, qparams: QuantizedParams, num_actions: int, use_noise: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.qparams = qparams
        self.num_actions = num_actions
        self.use_noise = use_noise
        self.compute_dtype = cdt = compute_dtype
        self.inv255 = float(torch.tensor(1.0 / 255.0, dtype=cdt))
        shapes = qparams.shapes
        self.dueling = "value_hidden.w_mu" in shapes
        heads = ("value", "advantage") if self.dueling else ("q",)
        self.noisy_names = tuple(f"{h}_{part}" for h in heads for part in ("hidden", "out"))
        if shapes[f"{self.noisy_names[-1]}.w_mu"][0] != num_actions:
            raise ValueError("QuantizedIQN: the weights' action count differs from num_actions")
        # K10d's leaves and their scratch: the conv weights and biases and the
        # embedding weight in the compute dtype, the embedding bias fp32 (K2
        # rounds it itself)
        leaves = [f"trunk.convs.{i}.{p}" for i in range(len(CONV_SPECS))
                  for p in ("weight", "bias")] + [f"{_EMBED}.weight", f"{_EMBED}.bias"]
        self.scratch = {name: torch.empty(shapes[name], device=qparams.device,
                                          dtype=torch.float32 if name == f"{_EMBED}.bias" else cdt)
                        for name in leaves}
        self._d_args = ([qparams.q[n] for n in leaves], [qparams.s[n] for n in leaves],
                        [self.scratch[n] for n in leaves])
        self._convs = [(self.scratch[f"trunk.convs.{i}.weight"],
                        self.scratch[f"trunk.convs.{i}.bias"]) for i in range(len(CONV_SPECS))]

    @property
    def device(self) -> torch.device:
        return self.qparams.device

    def load_(self, qparams: QuantizedParams) -> "QuantizedIQN":
        """New weights, copied in place into this holder's buffers."""
        self.qparams.copy_(qparams)
        return self

    def sample_noise(self, generator: Optional[torch.Generator]) -> Noise:
        out = {}
        for name in self.noisy_names:
            n_out, n_in = self.qparams.shapes[f"{name}.w_mu"]
            out[name] = (torch.randn(n_in, generator=generator, device=self.device),
                         torch.randn(n_out, generator=generator, device=self.device))
        return out

    def _linear(self, name: str, x: torch.Tensor, eps, relu: bool = False) -> torch.Tensor:
        q, s = self.qparams.q, self.qparams.s
        args = [x.to(self.compute_dtype), q[f"{name}.w_mu"], s[f"{name}.w_mu"],
                q[f"{name}.b_mu"], s[f"{name}.b_mu"]]
        if eps is not None:
            args += [q[f"{name}.w_sigma"], s[f"{name}.w_sigma"], q[f"{name}.b_sigma"],
                     s[f"{name}.b_sigma"], _f(eps[0]), _f(eps[1])]
        return noisy_linear_q(*args, relu=relu)  # K10g

    def __call__(self, obs: torch.Tensor, num_taus: int,
                 taus: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Noise] = None,
                 noisy: Optional[bool] = None) -> IQNOutput:
        cdt = self.compute_dtype
        batch = obs.shape[0]
        if obs.dtype == torch.uint8:
            obs = obs.to(cdt) * self.inv255
        dequantize(*self._d_args)  # K10d
        phi = conv_trunk(obs, self._convs, cdt)
        if taus is None:
            taus = torch.rand((batch, num_taus), generator=generator, device=obs.device)
        h = tau_embed(taus, self.scratch[f"{_EMBED}.weight"], self.scratch[f"{_EMBED}.bias"],
                      phi.to(cdt))  # K2
        use_noise = self.use_noise if noisy is None else noisy
        if use_noise and noise is None:
            noise = self.sample_noise(generator)
        eps = noise if use_noise else {}

        def head(name: str) -> torch.Tensor:
            hidden = self._linear(f"{name}_hidden", h, eps.get(f"{name}_hidden"), relu=True)
            return self._linear(f"{name}_out", hidden, eps.get(f"{name}_out"))

        value = head("value") if self.dueling else None
        adv = head("advantage" if self.dueling else "q")
        quantiles, q, action = dueling_head(value, adv, num_taus)  # K4
        return IQNOutput(quantiles, taus, q, action)


def make_quantized_network(cfg: Config, num_actions: int, qparams: QuantizedParams,
                           use_noise: bool = True) -> QuantizedIQN:
    """A ``QuantizedIQN`` for ``cfg`` on ``qparams``' device."""
    return QuantizedIQN(qparams, num_actions, use_noise=use_noise,
                        compute_dtype=getattr(torch, cfg.compute_dtype))
