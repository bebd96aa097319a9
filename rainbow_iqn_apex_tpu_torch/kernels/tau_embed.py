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
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K2_tau_embed"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/tau_embed.cu"
REPLACES = "rainbow_iqn_apex_tpu/models/layers.py:105"


def tau_embed_plain(taus: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    phi: torch.Tensor) -> torch.Tensor:
    """taus [B, N] fp32, weight [F, C] and phi [B, F] in the compute dtype,
    bias [F] -> h [B*N, F] in the compute dtype.  Rounds where the JAX model
    rounds: cos features, the Dense output, the bias add, the phi product."""
    cdt = phi.dtype
    batch, num_taus = taus.shape
    i = torch.arange(1, weight.shape[1] + 1, dtype=torch.float32, device=taus.device)
    cos = torch.cos(math.pi * taus[..., None] * i)  # [B, N, C] fp32
    dense = (cos.to(cdt).float() @ weight.to(cdt).float().t()).to(cdt)
    psi = torch.relu(dense + bias.to(cdt))
    h = phi[:, None, :] * psi
    return h.reshape(batch * num_taus, -1)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_tau_embed
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tau_embed(taus: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              phi: torch.Tensor) -> torch.Tensor:
    """K2 on ``taus.device``: the kernel on CUDA, the plain twin on the CPU."""
    if taus.device.type == "cpu":
        return tau_embed_plain(taus, weight, bias, phi)
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
    out = torch.empty((batch * num_taus, features), dtype=torch.bfloat16, device=taus.device)
    with torch.cuda.device(taus.device):
        code = _entry()(
            build.ptr(taus), build.ptr(weight), build.ptr(bias), build.ptr(phi),
            build.ptr(out), batch * num_taus, features, num_cos, num_taus,
            build.stream_of(taus.device))
    build.check_launch(NAME, code)
    return out
