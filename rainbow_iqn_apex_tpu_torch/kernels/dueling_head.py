"""K4: dueling combine, mean over tau and greedy argmax in one launch.

Replaces the dueling combine of ``rainbow_iqn_apex_tpu/models/iqn.py``
(:94-101) and its ``q_values`` / ``greedy_action`` (:105-111), which XLA
fuses on the TPU:

    quantiles = v + a - mean_a(a)    [B, N, A]   (a alone without dueling)
    q         = mean_tau quantiles   [B, A]
    action    = argmax_a q           [B] int32, the first index on ties

Bound on the H100: a few hundred KB at bucket 64, far under a microsecond of
memory time, so the launch is the cost.  The kernel
(``csrc/dueling_head.cu``) does all three steps with a warp per batch row,
``row_plan`` rows a block.

``dueling_head`` runs the kernel for CUDA tensors and ``dueling_head_plain``
for CPU tensors.

The learner's use of K4 (``ops/learn.py:140`` and ``:152``): ``dueling_gather``
runs the same kernel in gather mode, returning z [B, N] = quantiles at given
actions and q [B, A], and K4-bwd (``dueling_gather_bwd``, kernel
``csrc/dueling_head_bwd.cu``) is its backward: dvalue = dz, dadv = dz *
(1{a = a_b} - 1/A).  Both launch-bound.  ``DuelingGatherFn`` is the
``torch.autograd.Function`` over them (R2D2's).  K4-bwd's loss mode
(``dueling_loss_bwd``) is the IQN learn step's: it forms dz itself from
the cotangent of the weighted mean loss, the IS weights and K1's saved
gradient (``kernels/learn_loss.py``).

Multi-game runs (``multitask/``) add two modes of the same kernel, each
counted under its own name:

- K4m (``dueling_head(..., game=, mask=)``): each row's q set to
  ``MASK_FILL`` outside its game's action set (mask [G, A]) before the
  argmax, and returned masked: ``masked_q_values`` / ``masked_greedy_action``
  of ``rainbow_iqn_apex_tpu/multitask/model.py`` (:134-149).  The act step
  and the double-Q a* pass run it.
- K4l (``dueling_logp``): the log-softmax of the (masked) tau-mean q at a
  taken action, replay reuse's behaviour and current log-probs
  (``rainbow_iqn_apex_tpu/ops/learn.py`` ``make_policy_logp``, :172-195;
  masked, ``multitask/ops.py:180-193``).  Detached: no backward.

Both launch-bound like K4.

The learner's heads mode (``dueling_learn``, kernel ``port_dueling_learn``):
one launch takes the select, target and online heads of a learn step and
gives a* (masked as K4m when a mask is given), z_next at a*, td_target =
reward + discount * z_next, z_online at the taken action and the online q:
``rainbow_iqn_apex_tpu/ops/learn.py:125-152`` after the three forwards.  It
counts as K4m when the select head is masked, else as K4.
``kernels/learn_loss.py`` chains it with K1's weighted mode; only z_online
carries a gradient, through K4-bwd's loss mode.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K4_dueling_head"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/dueling_head.cu"
REPLACES = "rainbow_iqn_apex_tpu/models/iqn.py:94"
NAME_BWD = NAME + "_bwd"
SOURCE_BWD = "rainbow_iqn_apex_tpu_torch/csrc/dueling_head_bwd.cu"
REPLACES_BWD = "rainbow_iqn_apex_tpu/ops/learn.py:152"
NAME_MASK = "K4m_dueling_head_mask"
REPLACES_MASK = "rainbow_iqn_apex_tpu/multitask/model.py:134"
NAME_LOGP = "K4l_dueling_head_logp"
REPLACES_LOGP = "rainbow_iqn_apex_tpu/ops/learn.py:191"
REPLACES_LEARN = "rainbow_iqn_apex_tpu/ops/learn.py:125"
MASK_FILL = -1e9  # multitask/model.py:43: large-negative, not -inf
MAX_ROWS = 4  # rows (warps) a block in the row modes, csrc/dueling_head.cu
SMEM_LIMIT = 48 * 1024  # the kernels' dynamic shared memory, without an opt-in


def _tile_floats(num_taus: int, actions: int) -> int:
    return (num_taus * actions + 3) // 4 * 4


def row_plan(num_taus: int, actions: int) -> int:
    """Rows (warps) a block of the row modes: MAX_ROWS, fewer where their
    tiles would pass the shared memory limit; raises where one row does."""
    per_row = (_tile_floats(num_taus, actions) + _tile_floats(1, actions)) * 4
    if per_row > SMEM_LIMIT:
        raise ValueError(f"K4 keeps one row's [{num_taus}, {actions}] quantiles in "
                         f"{SMEM_LIMIT // 1024} KB of shared memory")
    return min(MAX_ROWS, SMEM_LIMIT // per_row)


def learn_smem(num_select: int, num_target: int, num_online: int, actions: int) -> int:
    """Shared memory bytes of one heads-mode block (one batch row's three
    tiles and two q rows); raises where they pass the limit."""
    floats = (_tile_floats(num_select, actions) + _tile_floats(num_target, actions)
              + _tile_floats(num_online, actions) + 2 * _tile_floats(1, actions))
    if floats * 4 > SMEM_LIMIT:
        raise ValueError(f"K4's heads mode keeps a row's three tiles ({num_select}, "
                         f"{num_target}, {num_online} taus x {actions}) in "
                         f"{SMEM_LIMIT // 1024} KB of shared memory")
    return floats * 4


def mask_q(q: torch.Tensor, game: Optional[torch.Tensor],
           mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B, A] with MASK_FILL where ``mask[game[b], a]`` is false (as is
    without a mask)."""
    if mask is None:
        return q
    return torch.where(mask.bool()[game.long()], q, torch.full_like(q, MASK_FILL))


def dueling_head_plain(value: Optional[torch.Tensor], adv: torch.Tensor, num_taus: int,
                       game: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """value [B*N, 1] or None, adv [B*N, A] fp32 -> (quantiles [B, N, A],
    q [B, A], action [B] int32); with ``game`` [B] and ``mask`` [G, A], q is
    masked (K4m) and the action stays inside each row's game."""
    q_all = adv if value is None else value + adv - adv.mean(dim=-1, keepdim=True)
    quantiles = q_all.reshape(-1, num_taus, adv.shape[-1]).float()
    q = mask_q(quantiles.mean(dim=1), game, mask)
    return quantiles, q, torch.argmax(q, dim=-1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_dueling_head
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_mask(game: Optional[torch.Tensor], mask: Optional[torch.Tensor], batch: int,
                actions: int, device: torch.device) -> Optional[torch.Tensor]:
    """The mask as uint8 [G, A] (or None); raises on what the kernel does not take."""
    if mask is None:
        return None
    if game is None or game.dtype != torch.int32 or tuple(game.shape) != (batch,):
        raise ValueError(f"K4m takes int32 game ids [{batch}] with the mask")
    if mask.dim() != 2 or mask.shape[1] != actions or mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"K4m takes a bool / uint8 mask [G, {actions}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if game.device != device or mask.device != device or not (
            game.is_contiguous() and mask.is_contiguous()):
        raise ValueError("K4 inputs must be contiguous on one device")
    return mask.view(torch.uint8)


def _check(value: Optional[torch.Tensor], adv: torch.Tensor, num_taus: int) -> None:
    rows, actions = adv.shape
    if rows % num_taus:
        raise ValueError(f"K4: {rows} rows are not a multiple of {num_taus} taus")
    tensors = (adv,) if value is None else (value, adv)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("K4 takes fp32 value and advantage")
    if value is not None and tuple(value.shape) != (rows, 1):
        raise ValueError(f"K4 value must be [{rows}, 1], got {tuple(value.shape)}")
    if any(t.device != adv.device or not t.is_contiguous() for t in tensors):
        raise ValueError("K4 inputs must be contiguous on one device")
    row_plan(num_taus, actions)


def dueling_head(value: Optional[torch.Tensor], adv: torch.Tensor, num_taus: int,
                 game: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 (K4m with ``game`` and ``mask``) on ``adv.device``: the kernel on
    CUDA, the plain twin on the CPU."""
    if adv.device.type == "cpu":
        return dueling_head_plain(value, adv, num_taus, game, mask)
    _check(value, adv, num_taus)
    rows, actions = adv.shape
    batch = rows // num_taus
    mask8 = _check_mask(game, mask, batch, actions, adv.device)
    quantiles = torch.empty((batch, num_taus, actions), dtype=torch.float32, device=adv.device)
    q = torch.empty((batch, actions), dtype=torch.float32, device=adv.device)
    action = torch.empty((batch,), dtype=torch.int32, device=adv.device)
    with torch.cuda.device(adv.device):
        code = _entry()(
            build.ptr(value), build.ptr(adv), build.ptr(quantiles), build.ptr(q),
            build.ptr(action), build.ptr(None), build.ptr(None),
            build.ptr(None if mask8 is None else game), build.ptr(mask8), build.ptr(None),
            batch, num_taus, actions, row_plan(num_taus, actions), build.stream_of(adv.device))
    build.check_launch(NAME if mask8 is None else NAME_MASK, code)
    return quantiles, q, action


def dueling_logp_plain(value: Optional[torch.Tensor], adv: torch.Tensor, num_taus: int,
                       take: torch.Tensor, game: Optional[torch.Tensor] = None,
                       mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logp [B], q [B, A]): the log-softmax of the (masked) tau-mean q at
    ``take`` [B] int32, and that q."""
    _, q, _ = dueling_head_plain(value, adv, num_taus, game, mask)
    logp = torch.log_softmax(q, dim=-1).gather(1, take.long()[:, None])[:, 0]
    return logp, q


def dueling_logp(value: Optional[torch.Tensor], adv: torch.Tensor, num_taus: int,
                 take: torch.Tensor, game: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4l on ``adv.device``: the kernel on CUDA, the plain twin on the CPU.
    An action out of range gives NaN on CUDA."""
    if adv.device.type == "cpu":
        return dueling_logp_plain(value, adv, num_taus, take, game, mask)
    _check(value, adv, num_taus)
    rows, actions = adv.shape
    batch = rows // num_taus
    if take.dtype != torch.int32 or tuple(take.shape) != (batch,):
        raise ValueError(f"K4l takes int32 actions [{batch}], got {take.dtype} "
                         f"{tuple(take.shape)}")
    if take.device != adv.device or not take.is_contiguous():
        raise ValueError("K4 inputs must be contiguous on one device")
    mask8 = _check_mask(game, mask, batch, actions, adv.device)
    q = torch.empty((batch, actions), dtype=torch.float32, device=adv.device)
    logp = torch.empty((batch,), dtype=torch.float32, device=adv.device)
    with torch.cuda.device(adv.device):
        code = _entry()(
            build.ptr(value), build.ptr(adv), build.ptr(None), build.ptr(q), build.ptr(None),
            build.ptr(take), build.ptr(None), build.ptr(None if mask8 is None else game),
            build.ptr(mask8), build.ptr(logp), batch, num_taus, actions,
            row_plan(num_taus, actions), build.stream_of(adv.device))
    build.check_launch(NAME_LOGP, code)
    return logp, q


def dueling_gather_plain(value: Optional[torch.Tensor], adv: torch.Tensor, num_taus: int,
                         take: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """value [B*N, 1] or None, adv [B*N, A] fp32, take [B] int32 ->
    (z [B, N] = quantiles[b, :, take[b]], q [B, A])."""
    quantiles, q, _ = dueling_head_plain(value, adv, num_taus)
    index = take.long()[:, None, None].expand(-1, num_taus, 1)
    return torch.gather(quantiles, 2, index)[..., 0], q


def dueling_gather(value: Optional[torch.Tensor], adv: torch.Tensor, num_taus: int,
                   take: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 in gather mode on ``adv.device``: the kernel on CUDA, the plain
    twin on the CPU.  An action out of range gathers NaN on CUDA."""
    if adv.device.type == "cpu":
        return dueling_gather_plain(value, adv, num_taus, take)
    _check(value, adv, num_taus)
    rows, actions = adv.shape
    batch = rows // num_taus
    if take.dtype != torch.int32 or tuple(take.shape) != (batch,):
        raise ValueError(f"K4 gather takes int32 actions [{batch}], got {take.dtype} "
                         f"{tuple(take.shape)}")
    if take.device != adv.device or not take.is_contiguous():
        raise ValueError("K4 inputs must be contiguous on one device")
    z = torch.empty((batch, num_taus), dtype=torch.float32, device=adv.device)
    q = torch.empty((batch, actions), dtype=torch.float32, device=adv.device)
    with torch.cuda.device(adv.device):
        code = _entry()(
            build.ptr(value), build.ptr(adv), build.ptr(None), build.ptr(q), build.ptr(None),
            build.ptr(take), build.ptr(z), build.ptr(None), build.ptr(None), build.ptr(None),
            batch, num_taus, actions, row_plan(num_taus, actions), build.stream_of(adv.device))
    build.check_launch(NAME, code)
    return z, q


def dueling_gather_bwd_plain(dz: torch.Tensor, take: torch.Tensor, num_actions: int,
                             dueling: bool) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Backward of the gather mode for dz [B, N] fp32 -> (dvalue [B*N, 1]
    or None, dadv [B*N, A])."""
    batch, num_taus = dz.shape
    onehot = torch.nn.functional.one_hot(take.long(), num_actions).to(dz.dtype)  # [B, A]
    dq = dz[:, :, None] * onehot[:, None, :]  # [B, N, A]
    if not dueling:
        return None, dq.reshape(batch * num_taus, num_actions)
    dadv = dq - dz[:, :, None] / num_actions
    return dz.reshape(batch * num_taus, 1), dadv.reshape(batch * num_taus, num_actions)


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = build.library().port_dueling_head_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bwd_launch(batch: int, num_taus: int, num_actions: int, dueling: bool,
                dev: torch.device, take: torch.Tensor,
                *operands: Optional[torch.Tensor]) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """One K4-bwd launch; ``operands`` are (dz, d_loss, weight, scale,
    grad), null where the mode takes none."""
    if take.dtype != torch.int32:
        raise TypeError(f"K4-bwd takes int32 actions, got {take.dtype}")
    if tuple(take.shape) != (batch,):
        raise ValueError(f"K4-bwd actions must be [{batch}], got {tuple(take.shape)}")
    for t in (take, *operands):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError("K4-bwd inputs must be contiguous on one device")
    rows = batch * num_taus
    dvalue = torch.empty((rows, 1), dtype=torch.float32, device=dev) if dueling else None
    dadv = torch.empty((rows, num_actions), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _bwd_entry()(*[build.ptr(t) for t in operands], build.ptr(take),
                            build.ptr(dvalue), build.ptr(dadv), batch, num_taus, num_actions,
                            build.stream_of(dev))
    build.check_launch(NAME_BWD, code)
    return dvalue, dadv


def dueling_gather_bwd(dz: torch.Tensor, take: torch.Tensor, num_actions: int,
                       dueling: bool) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """K4-bwd (dz mode) on ``dz.device``: the kernel on CUDA, the plain twin
    on the CPU."""
    if dz.device.type == "cpu":
        return dueling_gather_bwd_plain(dz, take, num_actions, dueling)
    if dz.dtype != torch.float32:
        raise TypeError("K4-bwd takes fp32 dz")
    batch, num_taus = dz.shape
    return _bwd_launch(batch, num_taus, num_actions, dueling, dz.device, take, dz, None, None,
                       None, None)


def dueling_loss_bwd_plain(d_loss: torch.Tensor, weight: torch.Tensor,
                           weight_scale: Optional[torch.Tensor], grad: torch.Tensor,
                           take: torch.Tensor, num_actions: int,
                           dueling: bool) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """K4-bwd's loss mode in plain torch: the cotangent ``d_loss`` [] of
    mean_b(w * per_sample) (w = weight, times ``weight_scale`` formed first)
    through that mean (MeanBackward, MulBackward) and K1's saved gradient
    ``grad`` [B, N] (the elementwise scale), then the gathers' backward."""
    batch = grad.shape[0]
    w = weight if weight_scale is None else weight * weight_scale
    d_per_sample = d_loss.expand(batch) / batch * w
    return dueling_gather_bwd_plain(d_per_sample[:, None] * grad, take, num_actions, dueling)


def dueling_loss_bwd(d_loss: torch.Tensor, weight: torch.Tensor,
                     weight_scale: Optional[torch.Tensor], grad: torch.Tensor,
                     take: torch.Tensor, num_actions: int,
                     dueling: bool) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """K4-bwd's loss mode on ``grad.device``: one launch on CUDA, reading
    the cotangent from the device (no host sync), the plain twin on the
    CPU."""
    if grad.device.type == "cpu":
        return dueling_loss_bwd_plain(d_loss, weight, weight_scale, grad, take, num_actions,
                                      dueling)
    batch, num_taus = grad.shape
    tensors = [t for t in (d_loss, weight, weight_scale, grad) if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("K4-bwd's loss mode takes an fp32 cotangent, weights and gradient")
    if d_loss.dim() != 0 or any(t.shape != (batch,) for t in (weight, weight_scale)
                                if t is not None):
        raise ValueError(f"K4-bwd's loss mode takes a 0-dim cotangent and weights [{batch}], "
                         f"got {tuple(d_loss.shape)}, {tuple(weight.shape)}")
    return _bwd_launch(batch, num_taus, num_actions, dueling, grad.device, take, None, d_loss,
                       weight, weight_scale, grad)


class DuelingGatherFn(torch.autograd.Function):
    """K4 gather forward, K4-bwd backward: (value, adv, take, num_taus) ->
    (z [B, N], q [B, A]), differentiable in value and adv through z; q (the
    q_mean metric's source) carries no gradient."""

    @staticmethod
    def forward(ctx, value, adv, take, num_taus):
        z, q = dueling_gather(value, adv, num_taus, take)
        ctx.save_for_backward(take)
        ctx.dueling = value is not None
        ctx.num_actions = adv.shape[1]
        ctx.mark_non_differentiable(q)
        return z, q

    @staticmethod
    def backward(ctx, dz, dq):
        (take,) = ctx.saved_tensors
        dvalue, dadv = dueling_gather_bwd(dz.contiguous(), take, ctx.num_actions, ctx.dueling)
        return dvalue, dadv, None, None


# ------------------------------------------------------ the learner's heads
Head = Tuple[Optional[torch.Tensor], torch.Tensor, int]  # (value [B*T, 1] or None, adv [B*T, A], T)


def dueling_learn_plain(select: Head, target: Head, online: Head, take: torch.Tensor,
                        reward: torch.Tensor, discount: torch.Tensor,
                        game: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                        ) -> Tuple[torch.Tensor, ...]:
    """The learn step's three heads -> (z_online [B, N], on_q [B, A],
    a_star [B] int32, z_next [B, N'], td_target [B, N']): a* the (masked)
    greedy action of ``select``, z_next ``target``'s quantiles at a*,
    td_target = reward + discount * z_next, z_online and on_q ``online``'s
    quantiles at ``take`` and its tau-mean."""
    _, _, a_star = dueling_head_plain(*select, game, mask)
    z_next, _ = dueling_gather_plain(*target, a_star)
    td_target = reward[:, None] + discount[:, None] * z_next
    z_online, on_q = dueling_gather_plain(*online, take)
    return z_online, on_q, a_star, z_next, td_target


@functools.lru_cache(maxsize=None)
def _learn_entry():
    fn = build.library().port_dueling_learn
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dueling_learn(select: Head, target: Head, online: Head, take: torch.Tensor,
                  reward: torch.Tensor, discount: torch.Tensor,
                  game: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, ...]:
    """K4's heads mode on the heads' device: one launch on CUDA, the plain
    twin on the CPU.  An out-of-range ``take`` gathers NaN on CUDA."""
    adv = online[1]
    if adv.device.type == "cpu":
        return dueling_learn_plain(select, target, online, take, reward, discount, game, mask)
    heads = (select, target, online)
    for value_, adv_, taus_ in heads:
        _check(value_, adv_, taus_)
    if len({h[0] is None for h in heads}) != 1:
        raise ValueError("K4's heads mode takes the value head of all three heads or of none")
    actions = adv.shape[1]
    batch = adv.shape[0] // online[2]
    if any(h[1].shape != (batch * h[2], actions) or h[1].device != adv.device for h in heads):
        raise ValueError(f"K4's heads mode takes [{batch} x taus, {actions}] heads on one device")
    for name, t, dtype in (("take", take, torch.int32), ("reward", reward, torch.float32),
                           ("discount", discount, torch.float32)):
        if t.dtype != dtype or tuple(t.shape) != (batch,) or t.device != adv.device or (
                not t.is_contiguous()):
            raise ValueError(f"K4's heads mode takes {name} as contiguous {dtype} [{batch}] "
                             f"on {adv.device}")
    mask8 = _check_mask(game, mask, batch, actions, adv.device)
    (sel_v, sel_a, k), (tgt_v, tgt_a, n_prime), (on_v, on_a, n) = heads
    learn_smem(k, n_prime, n, actions)
    dev = adv.device
    a_star = torch.empty((batch,), dtype=torch.int32, device=dev)
    z_next = torch.empty((batch, n_prime), dtype=torch.float32, device=dev)
    td_target = torch.empty((batch, n_prime), dtype=torch.float32, device=dev)
    z_online = torch.empty((batch, n), dtype=torch.float32, device=dev)
    on_q = torch.empty((batch, actions), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _learn_entry()(
            build.ptr(sel_v), build.ptr(sel_a), build.ptr(tgt_v), build.ptr(tgt_a),
            build.ptr(on_v), build.ptr(on_a), build.ptr(reward), build.ptr(discount),
            build.ptr(take), build.ptr(None if mask8 is None else game), build.ptr(mask8),
            build.ptr(a_star), build.ptr(z_next), build.ptr(td_target), build.ptr(z_online),
            build.ptr(on_q), batch, k, n_prime, n, actions, build.stream_of(dev))
    build.check_launch(NAME if mask8 is None else NAME_MASK, code)
    return z_online, on_q, a_star, z_next, td_target
