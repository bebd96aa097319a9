"""Building-block layers of the Rainbow-IQN network, in PyTorch.

Counterparts of ``rainbow_iqn_apex_tpu/models/layers.py``, with the same
numerics: matrix operands in the compute dtype (bfloat16 by default),
fp32 accumulation and fp32 NoisyLinear biases, fp32 parameters.

- Noise is never module state.  A NoisyLinear takes its standard-normal
  draws ``(eps_in, eps_out)`` as an argument, so the caller decides where
  they come from (an explicit ``torch.Generator``, or injected by a test).
- ``ConvTrunk`` takes NHWC frames, like the JAX trunk, and flattens phi in
  H, W, C order, so the weights after it line up with the JAX model's.
- The heavy parts run through the kernels of ``kernels/``: the tau
  embedding with its Hadamard merge (K2) and the NoisyLinear GEMMs (K3).
  With gradients on (the learner) they run through ``torch.autograd``
  Functions whose backward is a kernel too (K2-bwd, K3-bwd); acting under
  ``no_grad`` / ``inference_mode`` calls the forward kernels directly.
  The convolutions' backward is cuDNN's, by autograd.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear import NoisyLinearFn, noisy_linear
from rainbow_iqn_apex_tpu_torch.kernels.tau_embed import TauEmbedFn, tau_embed

Noise = Optional[Tuple[torch.Tensor, torch.Tensor]]

CONV_SPECS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))  # (features, kernel, stride)


def _f(x: torch.Tensor) -> torch.Tensor:
    """Factorised-noise squashing f(x) = sign(x) * sqrt(|x|)."""
    return torch.sign(x) * torch.sqrt(torch.abs(x))


def _tracked(*tensors: torch.Tensor) -> bool:
    """True when autograd records this call (the learner's online pass)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class NoisyLinear(nn.Module):
    """Factorised-Gaussian noisy linear layer.

    y = (w_mu + w_sigma * (f(eps_out) f(eps_in)^T)) x + (b_mu + b_sigma * f(eps_out))

    ``eps=None`` uses the mu parameters only (acting without noise).
    Weights are [out, in].
    """

    def __init__(self, in_features: int, out_features: int, sigma0: float = 0.5,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.sigma0 = sigma0
        self.compute_dtype = compute_dtype
        self.w_mu = nn.Parameter(torch.empty(out_features, in_features))
        self.b_mu = nn.Parameter(torch.empty(out_features))
        self.w_sigma = nn.Parameter(torch.empty(out_features, in_features))
        self.b_sigma = nn.Parameter(torch.empty(out_features))

    def sample_noise(self, generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fresh standard normals (eps_in [in], eps_out [out]) on the layer's device."""
        device = self.w_mu.device
        return (torch.randn(self.in_features, generator=generator, device=device),
                torch.randn(self.out_features, generator=generator, device=device))

    def forward(self, x: torch.Tensor, eps: Noise = None, relu: bool = False) -> torch.Tensor:
        cdt = self.compute_dtype
        xc = x.to(cdt)
        if eps is None:
            args = (xc, self.w_mu.to(cdt), self.b_mu, None, None, None, None)
        else:
            args = (xc, self.w_mu.to(cdt), self.b_mu, self.w_sigma.to(cdt), self.b_sigma,
                    _f(eps[0]), _f(eps[1]))
        if _tracked(x, self.w_mu):
            return NoisyLinearFn.apply(*args, relu)
        return noisy_linear(*args, relu=relu)


class CosineTauEmbedding(nn.Module):
    """IQN tau embedding psi(tau) = ReLU(Linear(cos(pi * i * tau), i=1..n)),
    merged with phi: taus [B, N], phi [B, F] -> phi * psi folded to [B*N, F].

    The JAX module returns psi alone and ``RainbowIQN`` merges it; here the
    merge is part of the same kernel (K2), so the module takes phi.
    """

    def __init__(self, features: int, num_cosines: int = 64,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embed = nn.Linear(num_cosines, features)

    def forward(self, taus: torch.Tensor, phi: torch.Tensor,
                game: Optional[torch.Tensor] = None,
                emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``game`` [B] int32 and ``emb`` [G, F] fp32 add the multi-game
        embedding to phi before the merge (K2g)."""
        cdt = self.compute_dtype
        args = (taus, self.embed.weight.to(cdt), self.embed.bias, phi.to(cdt))
        if emb is not None:
            args += (game.to(torch.int32).contiguous(), emb)
        if _tracked(phi, self.embed.weight, *(() if emb is None else (emb,))):
            return TauEmbedFn.apply(*args)
        return tau_embed(*args)


def trunk_features(height: int, width: int) -> int:
    """Flattened size of the conv trunk's output for an HxW frame."""
    for features, kernel, stride in CONV_SPECS:
        height = (height - kernel) // stride + 1
        width = (width - kernel) // stride + 1
    if height < 1 or width < 1:
        raise ValueError("frame too small for the conv trunk")
    return height * width * CONV_SPECS[-1][0]


class ConvTrunk(nn.Module):
    """Canonical DQN conv trunk (32x8x8/4, 64x4x4/2, 64x3x3/1), VALID padding.

    Takes NHWC input and returns phi [B, H'*W'*64] flattened in H, W, C
    order, as the JAX trunk does.  The NHWC input viewed as NCHW is
    channels-last in memory, so the convolutions run channels-last and the
    final flatten needs no copy.  Each conv rounds to the compute dtype before
    its bias add, as flax's conv does.
    """

    def __init__(self, in_channels: int, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        convs = []
        for features, kernel, stride in CONV_SPECS:
            convs.append(nn.Conv2d(in_channels, features, kernel, stride))
            in_channels = features
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_trunk(x, [(c.weight, c.bias) for c in self.convs], self.compute_dtype)


def conv_trunk(x: torch.Tensor, layers, cdt: torch.dtype) -> torch.Tensor:
    """``ConvTrunk``'s forward on given (weight, bias) pairs, one per
    ``CONV_SPECS`` entry: NHWC in, phi [B, H'*W'*64] out (H, W, C order)."""
    x = x.to(cdt).permute(0, 3, 1, 2)  # NHWC -> NCHW view
    for (weight, bias), (_, _, stride) in zip(layers, CONV_SPECS):
        x = F.conv2d(x, weight.to(cdt), stride=stride)
        x = torch.relu(x + bias.to(cdt)[:, None, None])
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
