"""K2: the IQN cosine-tau embedding fused with the Hadamard merge with phi.

Replaces ``rainbow_iqn_apex_tpu/models/layers.py`` CosineTauEmbedding
(:105-114) plus the merge and fold of ``models/iqn.py`` (:74-75), which XLA
fuses on the TPU:

    h[b*N + n, f] = ReLU(cos(pi * i * tau[b, n]) @ W_e^T + b_e)[f] * phi[b, f],  i = 1..C

Bound on the H100: the [B*N, F] bf16 output dominates the bytes (~13.7 MB at
bucket 64, K = 32, F = 3136: ~4 us at 3.35 TB/s); the products are < 1 us of
tensor-core time.  The kernel (``csrc/tau_embed.cu``) is a wgmma GEMM
whose cos-feature operand a thread-block cluster computes once per row tile
into its blocks' shared memory, W_e streamed by TMA, with the bias, ReLU
and phi product in its epilogue: each output element is written once, and
nothing but the output and its small inputs touches device memory.

``tau_embed`` runs the kernel for CUDA tensors and ``tau_embed_plain`` for
CPU tensors.  The kernel takes bf16 operands only, ``num_cosines`` from 1 to
``MAX_COSINES`` (two 64-wide boxes of the cos depth in shared memory; the
depth is zero-padded to the MMA's 16), any number of taus a row, and
``features % 8 == 0`` (16-byte rows).  With ``save_cos`` it also writes the
cos features, transposed and padded ([Cp, Mp]: ``cos_shape``), for K2-bwd.

K2-bwd, its backward (``tau_embed_bwd``, kernel ``csrc/tau_embed_bwd.cu``,
plain twin ``tau_embed_bwd_plain``), recomputes psi from those saved cos
features rather than saving the [B*N, F] tensor and returns dphi [B, F],
dW_e [F, C] (compute dtype) and db_e [F] (fp32, rounded to the compute dtype
as the JAX bias cotangent is).  Memory-bound: dh is ~13 MB at M = 2048, ~4
us at 3.35 TB/s.  ``TauEmbedFn`` is the ``torch.autograd.Function`` over K2
and K2-bwd; it has K2 save the cos features when a gradient is needed.

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
from typing import Callable, Optional

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

MAX_COSINES = 128  # the padded cos depth of two 64-wide shared-memory boxes
SMS = 132  # streaming multiprocessors of the H100 SXM: the wave the plans fill
TILE = 64  # rows and features of one wgmma tile


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def cos_shape(rows: int, num_cos: int) -> tuple:
    """The saved cos features' layout, [Cp, Mp]: the depth padded to the
    MMA's 16, the B*N rows to whole 64-row tiles, the pads zero."""
    return (_cdiv(num_cos, 16) * 16, _cdiv(rows, TILE) * TILE)


def forward_plan(rows: int, features: int, num_cos: int, game: bool = False,
                 max_clusters: Optional[Callable[[int], int]] = None) -> tuple:
    """K2's launch plan: (splits, cluster).  Block (s, rt) takes row tile rt
    against the s-th of ``splits`` contiguous runs of 64-feature tiles, and
    ``cluster`` blocks of one row (a divisor of splits, <= 8, the portable
    size) compute its cos features together.  Picks the splits that finish
    soonest: waves of the card (``max_clusters(size)`` clusters at once from
    the occupancy query; else three blocks an SM, two for K2g or a cos depth
    of two boxes) times the longest run plus the block's share of the cos
    features, which cost about six feature tiles' work a 64 x 64 tile."""
    row_tiles, tiles = _cdiv(rows, TILE), _cdiv(features, TILE)
    per_sm = 3 if num_cos <= TILE and not game else 2
    depth_boxes = _cdiv(num_cos, TILE)
    best = None
    for splits in range(1, tiles + 1):
        size = max(d for d in range(1, 9) if splits % d == 0)
        room = max_clusters(size) * size if max_clusters is not None else 0
        waves = _cdiv(row_tiles * splits, room or per_sm * SMS)
        cost = waves * (_cdiv(tiles, splits) + 6.0 * depth_boxes / size)
        if best is None or cost < best[0]:
            best = (cost, splits, size)
    return best[1], best[2]


def backward_plan(rows: int, taus_per_row: int, feature_tiles: int = 0,
                  max_clusters: Optional[Callable[[int], int]] = None) -> tuple:
    """K2-bwd's split of the B*N rows: (rows per block, blocks of M in a
    cluster).  A block holds whole samples (a multiple of lcm(64, N) rows,
    so its dphi completes inside it) and a cluster at most 8 blocks, the
    portable cluster size: the most blocks for which the card still holds
    all ``feature_tiles`` clusters at once (``max_clusters(size)``, the
    occupancy query; 0 or None: no limit known)."""
    unit = math.lcm(TILE, taus_per_row)
    units = _cdiv(rows, unit)
    for size in range(min(8, units), 0, -1):
        per_block = _cdiv(units, size) * unit
        clusters = _cdiv(rows, per_block)
        room = max_clusters(clusters) if max_clusters is not None else 0
        if room == 0 or feature_tiles <= room:
            break
    return per_block, clusters


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
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fwd_clusters(size: int, boxes: int, game: bool) -> int:
    """Clusters of ``size`` K2 blocks the card holds at once; 0 where the
    runtime cannot say."""
    fn = build.library().port_tau_embed_max_clusters
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return int(fn(size, boxes, int(game)))


@functools.lru_cache(maxsize=256)
def _card_forward_plan(rows: int, features: int, num_cos: int, game: bool) -> tuple:
    boxes = _cdiv(num_cos, TILE)
    return forward_plan(rows, features, num_cos, game,
                        lambda size: _fwd_clusters(size, boxes, game))


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


def _check_cos(num_cos: int, features: int, what: str) -> None:
    if not 1 <= num_cos <= MAX_COSINES:
        raise ValueError(f"{what} takes 1 <= num_cosines <= {MAX_COSINES} (two 64-wide "
                         f"boxes of shared memory), got {num_cos}")
    if features % 8:
        raise ValueError(f"{what} needs features % 8 == 0 (16-byte rows), got {features}")


def tau_embed(taus: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              phi: torch.Tensor, game: Optional[torch.Tensor] = None,
              emb: Optional[torch.Tensor] = None, save_cos: bool = False):
    """K2 (K2g with ``game`` and ``emb``) on ``taus.device``: the kernel on
    CUDA, the plain twin on the CPU.  Out-of-range game ids are the caller's
    to rule out: the kernel reads E at them.  ``save_cos`` returns (h, cos_t)
    with the cos features K2-bwd reads ([Cp, Mp] bf16, ``cos_shape``); on
    the CPU cos_t is None, the plain backward recomputes them."""
    if taus.device.type == "cpu":
        h = tau_embed_plain(taus, weight, bias, phi, game, emb)
        return (h, None) if save_cos else h
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
    _check_cos(num_cos, features, "K2")
    for t in (taus, weight, bias, phi):
        if t.device != taus.device or not t.is_contiguous():
            raise ValueError("K2 inputs must be contiguous on one device")
    if any(t.data_ptr() % 16 for t in (weight, bias, phi)):
        raise ValueError("K2 weight, bias and phi must be 16-byte aligned")
    _check_game(game, emb, batch, features, taus.device, "K2g")
    if emb is not None and emb.data_ptr() % 16:
        raise ValueError("K2g's embedding must be 16-byte aligned")
    rows = batch * num_taus
    dev = taus.device
    out = torch.empty((rows, features), dtype=torch.bfloat16, device=dev)
    cos_t = torch.empty(cos_shape(rows, num_cos), dtype=torch.bfloat16, device=dev) if save_cos else None
    with torch.cuda.device(dev):
        splits, cluster = _card_forward_plan(rows, features, num_cos, emb is not None)
        code = _entry()(
            build.ptr(taus), build.ptr(weight), build.ptr(bias), build.ptr(phi),
            build.ptr(out), build.ptr(None if emb is None else game), build.ptr(emb),
            build.ptr(cos_t), rows, features, num_cos, num_taus, splits, cluster,
            build.stream_of(dev))
    build.check_launch(NAME if emb is None else NAME_GAME, code)
    return (out, cos_t) if save_cos else out


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
def _max_clusters(size: int, wide: bool, taus_per_row: int) -> int:
    """Clusters of ``size`` K2-bwd blocks the card holds at once (num_cosines
    above 64 when ``wide``); 0 where the runtime cannot say."""
    fn = build.library().port_tau_embed_bwd_max_clusters
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return int(fn(size, 128 if wide else 64, taus_per_row))


@functools.lru_cache(maxsize=256)
def _card_backward_plan(rows: int, taus_per_row: int, features: int, num_cos: int) -> tuple:
    wide = cos_shape(rows, num_cos)[0] > TILE
    return backward_plan(rows, taus_per_row, _cdiv(features, TILE),
                         lambda size: _max_clusters(size, wide, taus_per_row))


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = build.library().port_tau_embed_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tau_embed_bwd(taus: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  phi: torch.Tensor, dh: torch.Tensor, game: Optional[torch.Tensor] = None,
                  emb: Optional[torch.Tensor] = None, cos_t: Optional[torch.Tensor] = None):
    """K2-bwd (K2g-bwd with ``game`` and ``emb``, which adds dE) on
    ``taus.device``: the kernel on CUDA, which reads ``cos_t``, the cos
    features that ``tau_embed(..., save_cos=True)`` returned for these taus;
    the plain twin on the CPU, which recomputes them from ``taus``."""
    if taus.device.type == "cpu":
        return tau_embed_bwd_plain(taus, weight, bias, phi, dh, game, emb)
    batch, num_taus = taus.shape
    features, num_cos = weight.shape
    rows = batch * num_taus
    if taus.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("K2-bwd takes fp32 taus and bias")
    if any(t.dtype != torch.bfloat16 for t in (weight, phi, dh)):
        raise TypeError("K2-bwd takes bf16 weight, phi and dh")
    if (tuple(bias.shape) != (features,) or tuple(phi.shape) != (batch, features)
            or tuple(dh.shape) != (rows, features)):
        raise ValueError(f"K2-bwd shape mismatch: weight {tuple(weight.shape)}, phi "
                         f"{tuple(phi.shape)}, dh {tuple(dh.shape)}")
    _check_cos(num_cos, features, "K2-bwd")
    if (cos_t is None or cos_t.dtype != torch.bfloat16
            or tuple(cos_t.shape) != cos_shape(rows, num_cos)):
        raise ValueError("K2-bwd reads the cos features K2 saved: pass cos_t from "
                         f"tau_embed(..., save_cos=True), bf16 {cos_shape(rows, num_cos)}")
    for t in (taus, weight, bias, phi, dh, cos_t):
        if t.device != taus.device or not t.is_contiguous():
            raise ValueError("K2-bwd inputs must be contiguous on one device")
    if any(t.data_ptr() % 16 for t in (weight, bias, phi, dh, cos_t)):
        raise ValueError("K2-bwd weight, bias, phi, dh and cos_t must be 16-byte aligned")
    dev = taus.device
    _check_game(game, emb, batch, features, dev, "K2g-bwd")
    dphi = torch.empty((batch, features), dtype=torch.bfloat16, device=dev)
    dw = torch.empty((features, num_cos), dtype=torch.bfloat16, device=dev)
    db = torch.empty((features,), dtype=torch.float32, device=dev)
    demb = None if emb is None else torch.empty(emb.shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        per_block, clusters = _card_backward_plan(rows, num_taus, features, num_cos)
        code = _bwd_entry()(
            build.ptr(cos_t), build.ptr(weight), build.ptr(bias), build.ptr(phi), build.ptr(dh),
            build.ptr(dphi), build.ptr(dw), build.ptr(db), build.ptr(None if emb is None else game),
            build.ptr(emb), build.ptr(demb), batch, num_taus, features, num_cos,
            0 if emb is None else emb.shape[0], per_block, clusters, build.stream_of(dev))
    build.check_launch(NAME_BWD if emb is None else NAME_GAME_BWD, code)
    return (dphi, dw, db) if emb is None else (dphi, dw, db, demb)


class TauEmbedFn(torch.autograd.Function):
    """K2 forward, K2-bwd backward: (taus, weight, bias, phi, game, emb) ->
    h, differentiable in weight, bias, phi and emb (taus and game get no
    gradient); ``game`` and ``emb`` None is K2, else K2g and K2g-bwd."""

    @staticmethod
    def forward(ctx, taus, weight, bias, phi, game=None, emb=None):
        h, cos_t = tau_embed(taus, weight, bias, phi, game, emb, save_cos=True)
        ctx.save_for_backward(taus, weight, bias, phi, game, emb, cos_t)
        return h

    @staticmethod
    def backward(ctx, dh):
        taus, weight, bias, phi, game, emb, cos_t = ctx.saved_tensors
        grads = tau_embed_bwd(taus, weight, bias, phi, dh.contiguous(), game, emb, cos_t)
        demb = grads[3] if emb is not None else None
        return None, grads[1], grads[2], grads[0], None, demb
