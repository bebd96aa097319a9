"""K8: n-step assembly, frame-stack gathers and IS weights at given slot ids.

Replaces ``DeviceReplay.assemble`` and ``_gather_stacks``
(``rainbow_iqn_apex_tpu/replay/device.py:222-273``, :182-205) and
``sample_grouped``'s per-group weights (:314-317).  For draws ``idx`` [M]
int32 into the ring ``state`` (the ``DeviceReplayState`` tensors):

    reward   = sum_k gamma^k r_k alive_k (alive_k: no terminal before k)   [M] f32
    discount = gamma^n, or 0 when a terminal lies in the n-step window      [M] f32
    obs, next_obs = [M, H, W, h] uint8 stacks ending at off and off + n, a frame
               zeroed behind an in-window cut or older than the written history
    prob     = max(p[idx] / max(total, 1e-12), 1e-12)                        [M] f32
    weight   = (filled * L * prob)^-beta over its max in each group of ``group``
               consecutive draws (ones when ``with_weight`` is off)          [M] f32

``total`` is K5's on-device sum of the priorities.  The return sums its n
terms left to right, as XLA reduces a short row.  The kernel clamps an id
outside [0, L * S) into it (as XLA clamps an out-of-bounds gather); the
twin raises on one.

Bound on the H100: the gathered frames in and the stacks out, ~3.4 MB at
B = 32, 84 x 84, h = 4, n = 3 (~1 us), so the kernel (``csrc/replay_assemble.cu``)
is a count of round trips.  One launch: each stack is cut into chunks of its
16-pixel vectors (``assemble_plan``: at least two blocks an SM at B 32), each
warp works out its stack's frames and cut mask itself (a ballot, no block
barrier), issues all of its 16-byte frame loads before any store and, at h
4, transposes 16 pixels x 4 frames in registers into four 16-byte stores;
beside the copy blocks, a warp a group of draws computes the scalars, lane i
taking draw i, and the group's weight maximum by shuffles.

``replay_assemble`` runs the kernel for CUDA tensors and
``replay_assemble_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, NamedTuple, Tuple

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K8_replay_assemble"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/replay_assemble.cu"
REPLACES = "rainbow_iqn_apex_tpu/replay/device.py:222"
MAX_THREADS = 256  # a block of the kernel
VEC_MAX = 4  # 16-pixel vectors a thread of the 16-byte path
BLOCKS_PER_SM = 2  # copy blocks an SM the plan asks for at least


def assemble_plan(draws: int, hw: int, sms: int) -> Tuple[int, int, int]:
    """(chunks, per_chunk, threads): each of the ``2 * draws`` stacks is cut
    into ``chunks`` runs of ``per_chunk`` of its ceil(hw / 16) 16-pixel
    vectors (the last run may be shorter, none is empty), one block of
    ``threads`` a run; thread t of run c takes vectors c * per_chunk + t + i *
    threads, i < VEC_MAX.  Enough runs that the copy blocks give every one of
    ``sms`` SMs BLOCKS_PER_SM where the stacks' vectors allow it."""
    if draws < 1 or hw < 1 or sms < 1:
        raise ValueError(f"K8 plans draws, hw, sms >= 1, got {draws}, {hw}, {sms}")
    vectors = -(-hw // 16)
    fill = -(-BLOCKS_PER_SM * sms // (2 * draws))
    chunks = min(vectors, max(fill, -(-vectors // (MAX_THREADS * VEC_MAX))))
    per_chunk = -(-vectors // chunks)
    chunks = -(-vectors // per_chunk)
    return chunks, per_chunk, min(MAX_THREADS, 32 * -(-per_chunk // 32))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class Assembled(NamedTuple):
    obs: torch.Tensor  # [M, H, W, h] uint8
    next_obs: torch.Tensor  # [M, H, W, h] uint8
    action: torch.Tensor  # [M] int32
    reward: torch.Tensor  # [M] f32
    discount: torch.Tensor  # [M] f32
    weight: torch.Tensor  # [M] f32
    prob: torch.Tensor  # [M] f32


def gather_stacks_plain(state: Any, lane: torch.Tensor, off: torch.Tensor, filled: int,
                        history: int) -> torch.Tensor:
    """[M, H, W, h] stacks ending at lane-local ``off`` (``_gather_stacks``)."""
    seg = state.actions.shape[1]
    steps = torch.arange(-(history - 1), 1, device=off.device)
    raw = off[:, None] + steps[None, :]  # [M, h]
    offs = raw % seg
    stacks = state.frames[lane[:, None], offs]  # [M, h, H, W]
    cut_w = state.cuts[lane[:, None], offs[:, :-1]]  # [M, h - 1]
    dead_tail = torch.cumsum(cut_w.flip(1).to(torch.int32), dim=1).flip(1) > 0
    valid = torch.cat([~dead_tail, torch.ones_like(raw[:, :1], dtype=torch.bool)], dim=1)
    if filled < seg:
        valid &= raw >= 0
    stacks = stacks * valid[:, :, None, None].to(torch.uint8)
    return stacks.permute(0, 2, 3, 1).contiguous()


def replay_assemble_plain(state: Any, idx: torch.Tensor, total: torch.Tensor,
                          gammas: torch.Tensor, beta: float, filled: int, history: int,
                          n_step: int, group: int, with_weight: bool = True) -> Assembled:
    lanes, seg = state.actions.shape
    ids = idx.long()
    prob = torch.clamp_min(state.priority[ids] / torch.clamp_min(total, 1e-12), 1e-12)
    lane, off = ids // seg, ids % seg
    f_offs = (off[:, None] + torch.arange(n_step, device=idx.device)[None, :]) % seg
    r = state.rewards[lane[:, None], f_offs]
    d = state.terminals[lane[:, None], f_offs]
    alive = torch.cumprod(1.0 - d[:, :-1].to(torch.float32), dim=1)
    alive = torch.cat([torch.ones_like(r[:, :1]), alive], dim=1)
    terms = r * alive * gammas[None, :n_step]
    reward = terms[:, 0]
    for k in range(1, n_step):  # left to right
        reward = reward + terms[:, k]
    discount = torch.where(d.any(dim=1), torch.zeros_like(reward), gammas[n_step])
    obs = gather_stacks_plain(state, lane, off, filled, history)
    next_obs = gather_stacks_plain(state, lane, (off + n_step) % seg, filled, history)
    if with_weight:
        w = (float(filled * lanes) * prob) ** (-beta)
        w = w.reshape(-1, group)
        weight = (w / w.amax(dim=1, keepdim=True)).reshape(-1)
    else:
        weight = torch.ones_like(prob)
    return Assembled(obs, next_obs, state.actions[lane, off], reward, discount, weight, prob)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_replay_assemble
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_float]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def replay_assemble(state: Any, idx: torch.Tensor, total: torch.Tensor, gammas: torch.Tensor,
                    beta: float, filled: int, history: int, n_step: int, group: int,
                    with_weight: bool = True) -> Assembled:
    """K8 on the ring's device: the kernel on CUDA, the plain twin on the CPU."""
    if state.priority.device.type == "cpu":
        return replay_assemble_plain(state, idx, total, gammas, beta, filled, history, n_step,
                                     group, with_weight)
    lanes, seg, height, width = state.frames.shape
    dev = state.priority.device
    checks = {"frames": (state.frames, torch.uint8), "actions": (state.actions, torch.int32),
              "rewards": (state.rewards, torch.float32),
              "terminals": (state.terminals, torch.bool), "cuts": (state.cuts, torch.bool),
              "priority": (state.priority, torch.float32), "total": (total, torch.float32),
              "idx": (idx, torch.int32), "gammas": (gammas, torch.float32)}
    for name, (t, dtype) in checks.items():
        if t.dtype != dtype:
            raise TypeError(f"K8 takes {name} as {dtype}, got {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"K8 takes {name} contiguous on {dev}")
    draws = idx.numel()
    if (idx.dim() != 1 or total.dim() != 0 or gammas.numel() != n_step + 1
            or not 1 <= history <= 32 or group < 1 or draws % group):
        raise ValueError(f"K8: idx {tuple(idx.shape)}, history {history}, group {group}, "
                         f"gammas {tuple(gammas.shape)} for n_step {n_step}")
    stack = (draws, height, width, history)
    obs = torch.empty(stack, dtype=torch.uint8, device=dev)
    next_obs = torch.empty(stack, dtype=torch.uint8, device=dev)
    action = torch.empty((draws,), dtype=torch.int32, device=dev)
    scalars = torch.empty((4, draws), dtype=torch.float32, device=dev)
    reward, discount, weight, prob = scalars.unbind(0)
    plan = assemble_plan(max(draws, 1), height * width, _sms(dev.index))
    with torch.cuda.device(dev):
        code = _entry()(
            build.ptr(state.frames), build.ptr(state.actions), build.ptr(state.rewards),
            build.ptr(state.terminals), build.ptr(state.cuts), build.ptr(state.priority),
            build.ptr(total), build.ptr(idx), build.ptr(gammas), build.ptr(obs),
            build.ptr(next_obs), build.ptr(action), build.ptr(reward), build.ptr(discount),
            build.ptr(weight), build.ptr(prob), draws, seg, height * width, history, n_step,
            filled, lanes, group, float(beta), int(with_weight), *plan, build.stream_of(dev))
    build.check_launch(NAME, code)
    return Assembled(obs, next_obs, action, reward, discount, weight, prob)
