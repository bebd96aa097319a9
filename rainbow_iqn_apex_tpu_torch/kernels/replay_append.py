"""K7: one lockstep append tick of every lane into the device replay ring.

Replaces ``DeviceReplay.append`` (``rainbow_iqn_apex_tpu/replay/device.py:109-179``),
in place on the ring (``state``: any object with the ``DeviceReplayState``
tensors ``frames`` [L, S, H, W] uint8, ``actions`` [L, S] int32,
``rewards`` f32, ``terminals`` and ``cuts`` bool, ``priority`` [L * S] f32,
``max_priority`` [] f32).  Per lane, at the write cursor ``pos``:

- the frame, action, reward, terminal and cut (terminal | truncation);
- the fresh slot's priority -> 0, the h slots ahead of the cursor -> 0;
- the slot n back -> the actor's (|TD| + eps)^omega, or ``max_priority``
  when the actor gives none; 0 when the first cut of its window
  [pos - n, pos) is a truncation; its own old value while filled < n;
- ``max_priority`` -> max(max_priority, the actor priorities) once filled >= n.

``pos`` and ``filled`` are host counters; the caller advances them.

Bound on the H100: the L [H, W] frames in and out (225 KB at L = 16, 84 x 84),
launch-bound.  The kernel (``csrc/replay_append.cu``) is one launch of a
scalar block, whose first warp alone owns the small fields, the priorities
and ``max_priority`` (lane l takes ring lane l, every load issued at once,
the maximum a NaN-propagating shuffle reduction, no block barrier), beside
``append_plan``'s copy blocks, which move the frames as 16-byte vectors with
every load before any store.

``replay_append`` runs the kernel for CUDA tensors and
``replay_append_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Optional, Tuple

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build
from rainbow_iqn_apex_tpu_torch.kernels.replay_writeback import priority_power

NAME = "K7_replay_append"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/replay_append.cu"
REPLACES = "rainbow_iqn_apex_tpu/replay/device.py:109"
MAX_THREADS = 256  # a block of the kernel
PER_THREAD = 2  # 16-byte vectors a thread of a copy block


def append_plan(lanes: int, hw: int) -> Tuple[int, int, int]:
    """(copy_blocks, threads, per_thread): the L frames' ceil(hw / 16)
    16-byte vectors each, flat, thread t of copy block b taking vectors b *
    threads * per_thread + t + i * threads, i < per_thread; the scalar block
    comes on top."""
    if lanes < 1 or hw < 1:
        raise ValueError(f"K7 plans lanes, hw >= 1, got {lanes}, {hw}")
    units = lanes * -(-hw // 16)
    threads = min(MAX_THREADS, 32 * -(-units // (32 * PER_THREAD)))
    return -(-units // (threads * PER_THREAD)), threads, PER_THREAD


def replay_append_plain(state: Any, frames: torch.Tensor, actions: torch.Tensor,
                        rewards: torch.Tensor, terminals: torch.Tensor,
                        truncations: torch.Tensor, priorities: Optional[torch.Tensor],
                        pos: int, filled: int, history: int, n_step: int,
                        eps: float, omega: float) -> None:
    """The append tick in plain torch, in place on ``state``'s tensors."""
    lanes, seg = state.actions.shape
    dev = state.priority.device
    state.frames[:, pos] = frames
    state.actions[:, pos] = actions.to(torch.int32)
    state.rewards[:, pos] = rewards.to(torch.float32)
    state.terminals[:, pos] = terminals
    state.cuts[:, pos] = terminals | truncations

    base = torch.arange(lanes, device=dev) * seg
    ready_col = (pos - n_step) % seg
    ready = base + ready_col
    old_ready = state.priority[ready]
    if priorities is None:
        pri = state.max_priority.expand(lanes).clone()
    else:
        pri = priority_power(priorities.to(torch.float32) + eps, omega)
        if filled >= n_step:
            state.max_priority.copy_(torch.maximum(state.max_priority, pri.max()))
    w_cols = (ready_col + torch.arange(n_step, device=dev)) % seg
    cuts_w = state.cuts[:, w_cols]
    terms_w = state.terminals[:, w_cols]
    first_cut = cuts_w.to(torch.uint8).argmax(dim=1)
    first_is_trunc = ~terms_w.gather(1, first_cut[:, None])[:, 0]
    pri = torch.where(cuts_w.any(dim=1) & first_is_trunc, torch.zeros_like(pri), pri)
    if filled < n_step:
        pri = old_ready

    new_pos = (pos + 1) % seg
    dead = (base[:, None] + (new_pos + torch.arange(history, device=dev)) % seg).reshape(-1)
    state.priority.index_fill_(0, base + pos, 0.0)
    state.priority.index_fill_(0, dead, 0.0)
    state.priority[ready] = pri


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_replay_append
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def replay_append(state: Any, frames: torch.Tensor, actions: torch.Tensor,
                  rewards: torch.Tensor, terminals: torch.Tensor, truncations: torch.Tensor,
                  priorities: Optional[torch.Tensor], pos: int, filled: int, history: int,
                  n_step: int, eps: float, omega: float) -> None:
    """K7 on the ring's device: the kernel on CUDA, the plain twin on the CPU."""
    if state.priority.device.type == "cpu":
        return replay_append_plain(state, frames, actions, rewards, terminals, truncations,
                                   priorities, pos, filled, history, n_step, eps, omega)
    lanes, seg, height, width = state.frames.shape
    ring = {"frames": (state.frames, torch.uint8), "actions": (state.actions, torch.int32),
            "rewards": (state.rewards, torch.float32), "terminals": (state.terminals, torch.bool),
            "cuts": (state.cuts, torch.bool), "priority": (state.priority, torch.float32),
            "max_priority": (state.max_priority, torch.float32),
            "frame": (frames, torch.uint8), "action": (actions, torch.int32),
            "reward": (rewards, torch.float32), "terminal": (terminals, torch.bool),
            "truncation": (truncations, torch.bool)}
    if priorities is not None:
        ring["priorities"] = (priorities, torch.float32)
    dev = state.priority.device
    for name, (t, dtype) in ring.items():
        if t.dtype != dtype:
            raise TypeError(f"K7 takes {name} as {dtype}, got {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"K7 takes {name} contiguous on {dev}")
    if (tuple(frames.shape) != (lanes, height, width) or state.priority.numel() != lanes * seg
            or any(t.numel() != lanes for t in (actions, rewards, terminals, truncations))
            or (priorities is not None and priorities.numel() != lanes)):
        raise ValueError(f"K7 shape mismatch for a ring of {lanes} lanes x {seg} slots")
    if not (0 <= pos < seg and seg > history + n_step and 1 <= history and 1 <= n_step):
        raise ValueError(f"K7: pos {pos}, seg {seg}, history {history}, n_step {n_step}")
    with torch.cuda.device(dev):
        code = _entry()(
            build.ptr(state.frames), build.ptr(state.actions), build.ptr(state.rewards),
            build.ptr(state.terminals), build.ptr(state.cuts), build.ptr(state.priority),
            build.ptr(state.max_priority), build.ptr(frames), build.ptr(actions),
            build.ptr(rewards), build.ptr(terminals), build.ptr(truncations),
            build.ptr(priorities), lanes, seg, height * width, pos, filled, history, n_step,
            float(eps), float(omega), *append_plan(lanes, height * width),
            build.stream_of(dev))
    build.check_launch(NAME, code)
