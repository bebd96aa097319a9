"""K7s: one append tick of R2D2's device-resident sequence replay.

Replaces ``DeviceSequenceReplay.append``
(``rainbow_iqn_apex_tpu/replay/device_sequence.py:113-205``).  For each lane,
with k = buf_len[lane] and klen = k + 1:

    builder[lane, k]      = this step's frame, action, reward, terminal, c, h
    a lane emits on a cut (terminal or truncation) or a full window (klen == L),
    into ring row (pos + rank) % C, rank = its place among this tick's emitters:
      frames / actions / rewards / dones = the builder's first klen steps, 0 after
      valids = step < klen;  init_c / init_h = the builder's step 0;
      priority = max_priority
    a full window without a cut keeps its last L - stride steps at the front
    of the builder (buf_len = L - stride); a cut restarts it (buf_len = 0)

Who emits, where, and the new lengths depend only on buf_len and the host
env's cut flags, so ``plan_append`` computes them on the host (the port keeps
buf_len, pos and filled as host counters) and the kernel gets them, with
the tick's rewards and terminal flags, as launch arguments: a tick uploads
nothing but its frame.  The kernel writes the emitters' windows only, where
the JAX graph scatters every lane's into the scratch row C to keep its shapes
static: so the scratch row, and builder steps at or past the new buf_len,
are not part of the semantics.

Bound on the H100: a typical tick writes one step per lane and is
launch-bound; an emitting lane moves its window (L x H x W bytes) once into
the ring and its overlap once inside its builder.  The kernel
(``csrc/seq_append.cu``) gives each thread one 16-byte column of a lane's
builder, walked over all L steps in batches read before they are written,
which keeps the in-place carry-over (overlapping when stride < L - stride)
race-free.

``seq_append`` runs the kernel for CUDA tensors and ``seq_append_plain``
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K7s_seq_append"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/seq_append.cu"
REPLACES = "rainbow_iqn_apex_tpu/replay/device_sequence.py:113"
MAX_LANES = 256  # the kernel takes each lane's plan as a launch argument


@dataclasses.dataclass
class AppendPlan:
    """One tick's host-side bookkeeping (numpy [lanes] arrays and ints)."""

    k: np.ndarray  # int32: buf_len before the write (the step's builder index)
    slot: np.ndarray  # int32: ring row of the emitted window, -1 for none
    carry: np.ndarray  # bool: full window without a cut (keep the overlap)
    buf_len: np.ndarray  # int32: the lengths after the tick
    pos: int
    filled: int


def plan_append(buf_len: np.ndarray, terminals: np.ndarray, truncations: np.ndarray, pos: int,
                filled: int, capacity: int, seq_len: int, stride: int) -> AppendPlan:
    """JAX's emission rule (device_sequence.py:137-201) on host counters."""
    k = np.asarray(buf_len, np.int32)
    klen = k + 1
    cut = np.asarray(terminals, bool) | np.asarray(truncations, bool)
    emit = cut | (klen == seq_len)
    rank = np.cumsum(emit) - 1
    slot = np.where(emit, (pos + rank) % capacity, -1).astype(np.int32)
    n_emit = int(emit.sum())
    new_len = np.where(cut, 0, np.where(emit, seq_len - stride, klen)).astype(np.int32)
    return AppendPlan(k=k, slot=slot, carry=emit & ~cut, buf_len=new_len,
                      pos=(pos + n_emit) % capacity, filled=min(filled + n_emit, capacity))


def seq_append_plain(state, frames: torch.Tensor, actions: torch.Tensor, rewards: np.ndarray,
                     terminals: np.ndarray, lstm_c: torch.Tensor, lstm_h: torch.Tensor,
                     plan: AppendPlan, stride: int) -> None:
    """The tick on ``state`` (a ``DeviceSeqState``) in place, lane by lane."""
    steps = state.buf_frames.shape[1]
    builders = (state.buf_frames, state.buf_actions, state.buf_rewards, state.buf_dones,
                state.buf_c, state.buf_h)
    for lane in range(frames.shape[0]):
        k, slot = int(plan.k[lane]), int(plan.slot[lane])
        state.buf_frames[lane, k].copy_(frames[lane])
        state.buf_actions[lane, k:k + 1].copy_(actions[lane:lane + 1])
        state.buf_rewards[lane, k:k + 1].fill_(float(rewards[lane]))
        state.buf_dones[lane, k:k + 1].fill_(bool(terminals[lane]))
        state.buf_c[lane, k].copy_(lstm_c[lane])
        state.buf_h[lane, k].copy_(lstm_h[lane])
        if slot < 0:
            continue
        kl = k + 1
        for ring, buf in zip((state.frames, state.actions, state.rewards, state.dones),
                             builders):
            ring[slot, :kl].copy_(buf[lane, :kl])
            ring[slot, kl:].zero_()
        state.valids[slot, :kl].fill_(True)
        state.valids[slot, kl:].fill_(False)
        state.init_c[slot].copy_(state.buf_c[lane, 0])
        state.init_h[slot].copy_(state.buf_h[lane, 0])
        state.priority[slot:slot + 1].copy_(state.max_priority.reshape(1))
        if plan.carry[lane]:
            for buf in builders:
                buf[lane, :steps - stride] = buf[lane, stride:].clone()


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_seq_append
    fn.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def seq_append(state, frames: torch.Tensor, actions: torch.Tensor, rewards: np.ndarray,
               terminals: np.ndarray, lstm_c: torch.Tensor, lstm_h: torch.Tensor,
               plan: AppendPlan, stride: int) -> None:
    """K7s on the ring's device: the kernel on CUDA, the plain twin on the
    CPU.  ``frames`` [lanes, H, W] uint8, ``actions`` [lanes] int32,
    ``lstm_c`` / ``lstm_h`` [lanes, lstm] f32 on the ring's device;
    ``rewards`` and ``terminals`` host arrays; ``plan`` from
    ``plan_append``."""
    dev = state.priority.device
    if dev.type == "cpu":
        return seq_append_plain(state, frames, actions, rewards, terminals, lstm_c, lstm_h,
                                plan, stride)
    lanes = frames.shape[0]
    _, steps, height, width = state.frames.shape
    lstm = state.init_c.shape[1]
    hw = height * width
    if not 1 <= lanes <= MAX_LANES or lanes != state.buf_frames.shape[0]:
        raise ValueError(f"K7s takes 1 to {MAX_LANES} lanes, the builders' count; got {lanes}")
    if lstm % 4 or not 1 <= stride <= steps:
        raise ValueError(f"K7s takes an LSTM width divisible by 4 and 1 <= stride <= L, got "
                         f"{lstm} and {stride}")
    if (frames.dtype, actions.dtype, lstm_c.dtype, lstm_h.dtype) != (
            torch.uint8, torch.int32, torch.float32, torch.float32):
        raise TypeError("K7s takes uint8 frames, int32 actions, fp32 LSTM states")
    if (tuple(frames.shape) != (lanes, height, width) or tuple(actions.shape) != (lanes,)
            or tuple(lstm_c.shape) != (lanes, lstm) or tuple(lstm_h.shape) != (lanes, lstm)):
        raise ValueError("K7s shape mismatch: frames [lanes, H, W], actions [lanes], "
                         "lstm_c / lstm_h [lanes, lstm]")
    ring = (state.frames, state.actions, state.rewards, state.dones, state.valids,
            state.init_c, state.init_h, state.priority, state.max_priority, state.buf_frames,
            state.buf_actions, state.buf_rewards, state.buf_dones, state.buf_c, state.buf_h)
    for t in (frames, actions, lstm_c, lstm_h, *ring):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("K7s inputs must be contiguous on the ring's device")
    for t in (lstm_c, lstm_h, state.init_c, state.init_h, state.buf_c, state.buf_h):
        if t.data_ptr() % 16:
            raise ValueError("K7s moves the LSTM states as 16-byte vectors: align them")
    vec16 = hw % 16 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (frames, state.frames, state.buf_frames))
    host = [np.ascontiguousarray(a, dtype) for a, dtype in (
        (plan.k, np.int32), (plan.slot, np.int32), (rewards, np.float32),
        (np.asarray(terminals, bool) * 1 + np.asarray(plan.carry, bool) * 2, np.uint8))]
    with torch.cuda.device(dev):
        code = _entry()(build.ptr(frames), build.ptr(actions), build.ptr(lstm_c),
                        build.ptr(lstm_h), *(build.ptr(t) for t in ring),
                        *(a.ctypes.data_as(ctypes.c_void_p) for a in host), lanes, steps, hw,
                        lstm, stride, int(vec16), build.stream_of(dev))
    build.check_launch(NAME, code)
