"""K4: dueling combine, mean over tau and greedy argmax in one launch.

Replaces the dueling combine of ``rainbow_iqn_apex_tpu/models/iqn.py``
(:94-101) and its ``q_values`` / ``greedy_action`` (:105-111), which XLA
fuses on the TPU:

    quantiles = v + a - mean_a(a)    [B, N, A]   (a alone without dueling)
    q         = mean_tau quantiles   [B, A]
    action    = argmax_a q           [B] int32, the first index on ties

Bound on the H100: a few hundred KB at bucket 64, far under a microsecond of
memory time, so the launch is the cost.  The kernel
(``csrc/dueling_head.cu``) does all three steps in one block per batch row.

``dueling_head`` runs the kernel for CUDA tensors and ``dueling_head_plain``
for CPU tensors.
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


def dueling_head_plain(value: Optional[torch.Tensor], adv: torch.Tensor,
                       num_taus: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """value [B*N, 1] or None, adv [B*N, A] fp32 -> (quantiles [B, N, A],
    q [B, A], action [B] int32)."""
    q_all = adv if value is None else value + adv - adv.mean(dim=-1, keepdim=True)
    quantiles = q_all.reshape(-1, num_taus, adv.shape[-1]).float()
    q = quantiles.mean(dim=1)
    return quantiles, q, torch.argmax(q, dim=-1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_dueling_head
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dueling_head(value: Optional[torch.Tensor], adv: torch.Tensor,
                 num_taus: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 on ``adv.device``: the kernel on CUDA, the plain twin on the CPU."""
    if adv.device.type == "cpu":
        return dueling_head_plain(value, adv, num_taus)
    rows, actions = adv.shape
    if rows % num_taus:
        raise ValueError(f"K4: {rows} rows are not a multiple of {num_taus} taus")
    batch = rows // num_taus
    tensors = (adv,) if value is None else (value, adv)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("K4 takes fp32 value and advantage")
    if value is not None and tuple(value.shape) != (rows, 1):
        raise ValueError(f"K4 value must be [{rows}, 1], got {tuple(value.shape)}")
    if any(t.device != adv.device or not t.is_contiguous() for t in tensors):
        raise ValueError("K4 inputs must be contiguous on one device")
    if (num_taus + 1) * actions > 12288:
        raise ValueError("K4 keeps one row's [N, A] quantiles in 48 KB of shared memory")
    quantiles = torch.empty((batch, num_taus, actions), dtype=torch.float32, device=adv.device)
    q = torch.empty((batch, actions), dtype=torch.float32, device=adv.device)
    action = torch.empty((batch,), dtype=torch.int32, device=adv.device)
    with torch.cuda.device(adv.device):
        code = _entry()(
            build.ptr(value), build.ptr(adv), build.ptr(quantiles), build.ptr(q),
            build.ptr(action), batch, num_taus, actions, build.stream_of(adv.device))
    build.check_launch(NAME, code)
    return quantiles, q, action
