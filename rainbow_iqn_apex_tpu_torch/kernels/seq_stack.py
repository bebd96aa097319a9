"""K8s-stack: the in-sequence frame stack of R2D2's learner.

Replaces ``rainbow_iqn_apex_tpu/ops/r2d2.py:stack_seq_frames`` (:59-77),
which XLA fuses on the TPU: single frames [B, L, H, W, 1] uint8 ->
[B, L, H, W, h], channel k holding the frame of step t - (h - 1 - k), zero
before the sequence starts.  Bound by bytes (27 MB in, 108 MB out at the
learner's [32, 120, 84, 84], h 4); the kernel (``csrc/seq_stack.cu``)
writes 16 bytes per thread.

``seq_stack`` runs the kernel for CUDA tensors and ``seq_stack_plain`` for
CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K8s_seq_stack"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/seq_stack.cu"
REPLACES = "rainbow_iqn_apex_tpu/ops/r2d2.py:59"


def seq_stack_plain(obs: torch.Tensor, history: int) -> torch.Tensor:
    """[B, L, H, W, 1] uint8 -> [B, L, H, W, history]."""
    steps = obs.shape[1]
    x = obs[..., 0]
    shifted = [F.pad(x[:, :steps - k], (0, 0, 0, 0, k, 0)) for k in range(history - 1, -1, -1)]
    return torch.stack(shifted, dim=-1)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_seq_stack
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def seq_stack(obs: torch.Tensor, history: int) -> torch.Tensor:
    """K8s-stack on ``obs.device``: the kernel on CUDA, the plain twin on the CPU."""
    if obs.device.type == "cpu":
        return seq_stack_plain(obs, history)
    if obs.dtype != torch.uint8 or obs.dim() != 5 or obs.shape[-1] != 1:
        raise ValueError(f"K8s-stack takes uint8 [B, L, H, W, 1] frames, got {obs.dtype} "
                         f"{tuple(obs.shape)}")
    if not obs.is_contiguous() or history < 1:
        raise ValueError("K8s-stack takes contiguous frames and a history of at least 1")
    batch, steps, height, width, _ = obs.shape
    out = torch.empty((batch, steps, height, width, history), dtype=torch.uint8, device=obs.device)
    with torch.cuda.device(obs.device):
        code = _entry()(build.ptr(obs), build.ptr(out), batch, steps, height * width, history,
                        build.stream_of(obs.device))
    build.check_launch(NAME, code)
    return out
