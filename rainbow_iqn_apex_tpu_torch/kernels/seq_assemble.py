"""K8s: the gather and IS weights of R2D2's device sequence replay.

Replaces ``DeviceSequenceReplay.assemble``
(``rainbow_iqn_apex_tpu/replay/device_sequence.py:234-262``) and
``sample_grouped``'s per-group weights (:277-281).  For draws ``idx`` [M]
(M = G * ``group``):

    obs, action, reward, done, valid, init_c, init_h = the ring's rows at idx
    prob     = max(p_eff[idx] / max(total, 1e-12), 1e-12)                   [M] f32
    weight   = (F * prob)^-beta over its max in each group of ``group``
               consecutive draws (ones when ``with_weight`` is off)         [M] f32

with F = max(filled, 1), and ``meta`` = [total, fallback] from K5s: p_eff is
the priorities, or 1 on slots [0, F) when they sum to 0 (the cold-ring
guard).  Slot ids are clamped into [0, C - 1]; K5s gives no other.  The
frames come back as [M, L, H, W]; the learner's K8s-stack takes them as
[M, L, H, W, 1].

Bound on the H100: bytes, B sequences of frames read and written once
(27.1 MB each way at B 32, L 120, 84x84).  The kernel
(``csrc/seq_assemble.cu``) copies 16 bytes a thread; the first row of each
group computes the group's weights with one block reduction for the maximum.

``seq_assemble`` runs the kernel for CUDA tensors and ``seq_assemble_plain``
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K8s_seq_assemble"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/seq_assemble.cu"
REPLACES = "rainbow_iqn_apex_tpu/replay/device_sequence.py:234"


@dataclasses.dataclass
class Gathered:
    obs: torch.Tensor  # [M, L, H, W] uint8
    action: torch.Tensor  # [M, L] int32
    reward: torch.Tensor  # [M, L] f32
    done: torch.Tensor  # [M, L] bool
    valid: torch.Tensor  # [M, L] bool
    init_c: torch.Tensor  # [M, lstm] f32
    init_h: torch.Tensor  # [M, lstm] f32
    weight: torch.Tensor  # [M] f32
    prob: torch.Tensor  # [M] f32


def seq_assemble_plain(state, idx: torch.Tensor, meta: torch.Tensor, beta: float, filled: int,
                       group: int, with_weight: bool = True) -> Gathered:
    """``state``: a ``DeviceSeqState``; idx [M] int32; meta [2] f32 from K5s."""
    capacity = state.priority.shape[0]
    ids = idx.long().clamp(0, capacity - 1)
    count = max(filled, 1)
    uniform = (torch.arange(capacity, device=idx.device) < count).to(torch.float32)
    p = torch.where(meta[1] != 0, uniform, state.priority)
    prob = torch.clamp_min(p[ids] / torch.clamp_min(meta[0], 1e-12), 1e-12)
    if with_weight:
        w = ((float(count) * prob) ** (-beta)).reshape(-1, group)
        weight = (w / w.amax(dim=1, keepdim=True)).reshape(-1)
    else:
        weight = torch.ones_like(prob)
    return Gathered(state.frames[ids], state.actions[ids], state.rewards[ids], state.dones[ids],
                    state.valids[ids], state.init_c[ids], state.init_h[ids], weight, prob)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_seq_assemble
    fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 7 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def seq_assemble(state, idx: torch.Tensor, meta: torch.Tensor, beta: float, filled: int,
                 group: int, with_weight: bool = True) -> Gathered:
    """K8s on the ring's device: the kernel on CUDA, the plain twin on the CPU."""
    dev = state.priority.device
    if dev.type == "cpu":
        return seq_assemble_plain(state, idx, meta, beta, filled, group, with_weight)
    draws = idx.numel()
    if idx.dtype != torch.int32 or idx.dim() != 1 or not 1 <= draws <= 65535:
        raise ValueError(f"K8s takes idx [M] int32, 1 <= M <= 65535, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if group < 1 or draws % group:
        raise ValueError(f"K8s: {draws} draws are not whole groups of {group}")
    if meta.dtype != torch.float32 or meta.shape != (2,):
        raise ValueError("K8s takes K5s's meta [2] f32")
    ring = (state.frames, state.actions, state.rewards, state.dones, state.valids,
            state.init_c, state.init_h, state.priority)
    for t in (*ring, idx, meta):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("K8s inputs must be contiguous on one device")
    _, steps, height, width = state.frames.shape
    lstm = state.init_c.shape[1]
    hw = height * width
    out = Gathered(
        obs=torch.empty((draws, steps, height, width), dtype=torch.uint8, device=dev),
        action=torch.empty((draws, steps), dtype=torch.int32, device=dev),
        reward=torch.empty((draws, steps), dtype=torch.float32, device=dev),
        done=torch.empty((draws, steps), dtype=torch.bool, device=dev),
        valid=torch.empty((draws, steps), dtype=torch.bool, device=dev),
        init_c=torch.empty((draws, lstm), dtype=torch.float32, device=dev),
        init_h=torch.empty((draws, lstm), dtype=torch.float32, device=dev),
        weight=torch.empty((draws,), dtype=torch.float32, device=dev),
        prob=torch.empty((draws,), dtype=torch.float32, device=dev))
    vec16 = (steps * hw) % 16 == 0 and state.frames.data_ptr() % 16 == 0 \
        and out.obs.data_ptr() % 16 == 0
    with torch.cuda.device(dev):
        code = _entry()(*(build.ptr(t) for t in (*ring[:7], state.priority, meta, idx)),
                        *(build.ptr(getattr(out, f.name)) for f in dataclasses.fields(out)),
                        draws, state.priority.shape[0], steps, hw, lstm, max(int(filled), 1),
                        group, float(beta), int(with_weight), int(vec16), build.stream_of(dev))
    build.check_launch(NAME, code)
    return out
