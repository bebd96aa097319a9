"""K2: the IQN cosine-tau embedding fused with the Hadamard merge with phi.

Replaces ``rainbow_iqn_apex_tpu/models/layers.py`` CosineTauEmbedding
(:105-114) plus the merge and fold of ``models/iqn.py`` (:74-75), which XLA
fuses on the TPU:

    h[b*N + n, f] = ReLU(cos(pi * i * tau[b, n]) @ W_e^T + b_e)[f] * phi[b, f],  i = 1..C

Bound on the H100: the [B*N, F] bf16 output dominates the bytes (~13.7 MB at
bucket 64, K = 32, F = 3136: ~4 us at 3.35 TB/s); the products are < 1 us of
tensor-core time.  The kernel (``csrc/tau_embed.cu``) is a tensor-core GEMM
whose cos-feature operand is computed in shared memory, with the bias, ReLU
and phi product in its epilogue: each output element is written once, and
nothing but the output and its small inputs touches device memory.

``tau_embed`` runs the kernel for CUDA tensors and ``tau_embed_plain`` for
CPU tensors.  The kernel takes bf16 operands only.

K2-bwd, its backward (``tau_embed_bwd``, kernel ``csrc/tau_embed_bwd.cu``,
plain twin ``tau_embed_bwd_plain``), recomputes psi rather than saving the
[B*N, F] tensor and returns dphi [B, F], dW_e [F, C] (compute dtype) and
db_e [F] (fp32, rounded to the compute dtype as the JAX bias cotangent is).
Memory-bound: dh is ~13 MB at M = 2048, ~4 us at 3.35 TB/s.
``TauEmbedFn`` is the ``torch.autograd.Function`` over K2 and K2-bwd.

K2g, multi-game runs' game embedding (``rainbow_iqn_apex_tpu/multitask/
model.py:80-90``): given ``game`` [B] int32 and ``emb`` E [G, F] fp32, the
merge uses phi_g = phi + E[game] (rounded as the JAX model rounds), inside
the same kernel, counted under its own name.  K2g-bwd returns dE [G, F]
fp32 as well: the per-game fp32 sum of dphi over the rows of that game, in
row order, in the same launch.  Null ``game`` and ``emb`` are K2 and K2-bwd.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K2_tau_embed"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/tau_embed.cu"
REPLACES = "rainbow_iqn_apex_tpu/models/layers.py:105"
NAME_BWD = NAME + "_bwd"
SOURCE_BWD = "rainbow_iqn_apex_tpu_torch/csrc/tau_embed_bwd.cu"
REPLACES_BWD = "rainbow_iqn_apex_tpu/models/layers.py:105"
NAME_GAME = "K2g_tau_embed_game"
NAME_GAME_BWD = NAME_GAME + "_bwd"
REPLACES_GAME = "rainbow_iqn_apex_tpu/multitask/model.py:80"


def _cos_features(taus: torch.Tensor, num_cos: int, cdt: torch.dtype) -> torch.Tensor:
    i = torch.arange(1, num_cos + 1, dtype=torch.float32, device=taus.device)
    return torch.cos(math.pi * taus[..., None] * i).to(cdt)  # [B, N, C]


def _pre_activation(cos: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    cdt = cos.dtype
    dense = (cos.float() @ weight.to(cdt).float().t()).to(cdt)
    return dense + bias.to(cdt)


def game_phi(phi: torch.Tensor, game: Optional[torch.Tensor],
             emb: Optional[torch.Tensor]) -> torch.Tensor:
    """phi_g = phi + E[game] in phi's dtype, E cast to it first (the
    rounding of ``multitask/model.py:89``); phi itself without E."""
    if emb is None:
        return phi
    return phi + emb[game.long()].to(phi.dtype)


def tau_embed_plain(taus: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    phi: torch.Tensor, game: Optional[torch.Tensor] = None,
                    emb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """taus [B, N] fp32, weight [F, C] and phi [B, F] in the compute dtype,
    bias [F] -> h [B*N, F] in the compute dtype.  Rounds where the JAX model
    rounds: cos features, the Dense output, the bias add, the phi product.
    With ``game`` [B] int32 and ``emb`` [G, F] fp32, phi is phi_g (K2g)."""
    phi = game_phi(phi, game, emb)
    batch, num_taus = taus.shape
    psi = torch.relu(_pre_activation(_cos_features(taus, weight.shape[1], phi.dtype),
                                     weight, bias))
    h = phi[:, None, :] * psi
    return h.reshape(batch * num_taus, -1)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_tau_embed
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_game(game: Optional[torch.Tensor], emb: Optional[torch.Tensor], batch: int,
                features: int, device: torch.device, what: str) -> None:
    if emb is None:
        return
    if game is None or game.dtype != torch.int32 or tuple(game.shape) != (batch,):
        raise ValueError(f"{what} takes int32 game ids [{batch}] with the embedding")
    if emb.dtype != torch.float32 or emb.dim() != 2 or emb.shape[1] != features:
        raise ValueError(f"{what} takes an fp32 embedding [G, {features}], got {emb.dtype} "
                         f"{tuple(emb.shape)}")
    for t in (game, emb):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{what} inputs must be contiguous on one device")


def tau_embed(taus: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              phi: torch.Tensor, game: Optional[torch.Tensor] = None,
              emb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 (K2g with ``game`` and ``emb``) on ``taus.device``: the kernel on
    CUDA, the plain twin on the CPU.  Out-of-range game ids are the caller's
    to rule out: the kernel reads E at them."""
    if taus.device.type == "cpu":
        return tau_embed_plain(taus, weight, bias, phi, game, emb)
    batch, num_taus = taus.shape
    features, num_cos = weight.shape
    if taus.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("K2 takes fp32 taus and bias")
    if weight.dtype != torch.bfloat16 or phi.dtype != torch.bfloat16:
        raise TypeError(
            f"K2 takes bf16 weight and phi, got {weight.dtype} and {phi.dtype} "
            "(the CUDA path needs compute_dtype='bfloat16')")
    if tuple(bias.shape) != (features,) or tuple(phi.shape) != (batch, features):
        raise ValueError(f"K2 shape mismatch: weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)}, phi {tuple(phi.shape)}")
    if num_cos % 16 or num_cos > 112:
        raise ValueError(f"K2 needs num_cosines % 16 == 0 and <= 112, got {num_cos}")
    if features % 8:
        raise ValueError(f"K2 needs features % 8 == 0, got {features}")
    for t in (taus, weight, bias, phi):
        if t.device != taus.device or not t.is_contiguous():
            raise ValueError("K2 inputs must be contiguous on one device")
    if weight.data_ptr() % 16 or phi.data_ptr() % 16:
        raise ValueError("K2 weight and phi must be 16-byte aligned")
    _check_game(game, emb, batch, features, taus.device, "K2g")
    out = torch.empty((batch * num_taus, features), dtype=torch.bfloat16, device=taus.device)
    with torch.cuda.device(taus.device):
        code = _entry()(
            build.ptr(taus), build.ptr(weight), build.ptr(bias), build.ptr(phi),
            build.ptr(out), build.ptr(None if emb is None else game), build.ptr(emb),
            batch * num_taus, features, num_cos, num_taus, build.stream_of(taus.device))
    build.check_launch(NAME if emb is None else NAME_GAME, code)
    return out


def game_embed_grad(dphi: torch.Tensor, game: torch.Tensor, num_games: int) -> torch.Tensor:
    """dE [G, F] fp32 = per-game sums of fp32(dphi) [B, F]: the transpose of
    the embedding gather (a one-hot product, plain torch)."""
    onehot = (game.long()[None, :] == torch.arange(num_games, device=game.device)[:, None])
    return onehot.float() @ dphi.float()


def tau_embed_bwd_plain(taus: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        phi: torch.Tensor, dh: torch.Tensor, game: Optional[torch.Tensor] = None,
                        emb: Optional[torch.Tensor] = None):
    """Backward of K2 for dh [B*N, F] in the compute dtype -> (dphi [B, F],
    dW_e [F, C] in the compute dtype, db_e [F] fp32), and with ``game`` and
    ``emb`` (K2g-bwd) dE [G, F] fp32 as a fourth.  The products round to the
    compute dtype as the jaxpr's do; sums run in fp32, rounded once."""
    if emb is not None:
        dphi, dw, db = tau_embed_bwd_plain(taus, weight, bias, game_phi(phi, game, emb), dh)
        return dphi, dw, db, game_embed_grad(dphi, game, emb.shape[0])
    cdt = phi.dtype
    batch, num_taus = taus.shape
    cos = _cos_features(taus, weight.shape[1], cdt)
    pre = _pre_activation(cos, weight, bias)  # [B, N, F]
    psi = torch.relu(pre)
    dh3 = dh.reshape(batch, num_taus, -1)
    dphi = (dh3 * psi).float().sum(dim=1).to(cdt)
    dpre = torch.where(pre > 0, dh3 * phi[:, None, :], torch.zeros_like(dh3))
    dpre = dpre.reshape(batch * num_taus, -1).float()
    dw = (dpre.t() @ cos.reshape(batch * num_taus, -1).float()).to(cdt)
    db = dpre.sum(dim=0).to(cdt).float()
    return dphi, dw, db


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = build.library().port_tau_embed_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tau_embed_bwd(taus: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  phi: torch.Tensor, dh: torch.Tensor, game: Optional[torch.Tensor] = None,
                  emb: Optional[torch.Tensor] = None):
    """K2-bwd (K2g-bwd with ``game`` and ``emb``, which adds dE) on
    ``taus.device``: the kernel on CUDA, the plain twin on the CPU."""
    if taus.device.type == "cpu":
        return tau_embed_bwd_plain(taus, weight, bias, phi, dh, game, emb)
    batch, num_taus = taus.shape
    features, num_cos = weight.shape
    if taus.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("K2-bwd takes fp32 taus and bias")
    if any(t.dtype != torch.bfloat16 for t in (weight, phi, dh)):
        raise TypeError("K2-bwd takes bf16 weight, phi and dh")
    if (tuple(bias.shape) != (features,) or tuple(phi.shape) != (batch, features)
            or tuple(dh.shape) != (batch * num_taus, features)):
        raise ValueError(f"K2-bwd shape mismatch: weight {tuple(weight.shape)}, phi "
                         f"{tuple(phi.shape)}, dh {tuple(dh.shape)}")
    if num_cos % 16 or num_cos > 128:
        raise ValueError(f"K2-bwd needs num_cosines % 16 == 0 and <= 128, got {num_cos}")
    if num_taus > 128:
        raise ValueError(f"K2-bwd keeps one row's taus in shared memory: <= 128, got {num_taus}")
    for t in (taus, weight, bias, phi, dh):
        if t.device != taus.device or not t.is_contiguous():
            raise ValueError("K2-bwd inputs must be contiguous on one device")
    if weight.data_ptr() % 16:
        raise ValueError("K2-bwd weight must be 16-byte aligned")
    dev = taus.device
    _check_game(game, emb, batch, features, dev, "K2g-bwd")
    dphi = torch.empty((batch, features), dtype=torch.bfloat16, device=dev)
    dw = torch.empty((features, num_cos), dtype=torch.bfloat16, device=dev)
    db = torch.empty((features,), dtype=torch.float32, device=dev)
    demb = None if emb is None else torch.empty(emb.shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _bwd_entry()(
            build.ptr(taus), build.ptr(weight), build.ptr(bias), build.ptr(phi), build.ptr(dh),
            build.ptr(dphi), build.ptr(dw), build.ptr(db), build.ptr(None if emb is None else game),
            build.ptr(emb), build.ptr(demb), batch, num_taus, features, num_cos,
            0 if emb is None else emb.shape[0], build.stream_of(dev))
    build.check_launch(NAME_BWD if emb is None else NAME_GAME_BWD, code)
    return (dphi, dw, db) if emb is None else (dphi, dw, db, demb)


class TauEmbedFn(torch.autograd.Function):
    """K2 forward, K2-bwd backward: (taus, weight, bias, phi, game, emb) ->
    h, differentiable in weight, bias, phi and emb (taus and game get no
    gradient); ``game`` and ``emb`` None is K2, else K2g and K2g-bwd."""

    @staticmethod
    def forward(ctx, taus, weight, bias, phi, game=None, emb=None):
        ctx.save_for_backward(taus, weight, bias, phi, game, emb)
        return tau_embed(taus, weight, bias, phi, game, emb)

    @staticmethod
    def backward(ctx, dh):
        taus, weight, bias, phi, game, emb = ctx.saved_tensors
        grads = tau_embed_bwd(taus, weight, bias, phi, dh.contiguous(), game, emb)
        demb = grads[3] if emb is not None else None
        return None, grads[1], grads[2], grads[0], None, demb
