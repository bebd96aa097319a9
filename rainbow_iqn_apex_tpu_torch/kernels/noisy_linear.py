"""K3: the factorised-noise NoisyLinear GEMM with its epilogue fused.

Replaces ``rainbow_iqn_apex_tpu/models/layers.py`` NoisyLinear.__call__
(:48-91) and the hidden ReLU of ``models/iqn.py`` (:85), which XLA fuses on
the TPU:

    greedy: y = x @ W_mu^T + b_mu
    noisy:  y = x @ W_mu^T + ((x * f_in) @ W_sigma^T) * f_out + b_mu + b_sigma * f_out

with f_in = f(eps_in), f_out = f(eps_out) and f(e) = sign(e) sqrt|e|, bf16
operands, fp32 accumulation, an fp32 bias and an fp32 output; ReLU after when
asked.  Weights are [N, K], torch's Linear layout.

Bound on the H100: each serving hidden layer (M = 2048, K = 3136, N = 512)
is 6.6 GFLOP, ~7 us at 989 TFLOP/s bf16, so compute-bound; the *_out layers
(N = 1, 18) are launch-bound.  The kernel (``csrc/noisy_linear.cu``) runs a
tiled tensor-core GEMM that, in noisy mode, loads each x tile once for both
products and never forms the [N, K] noise matrix; the noise scale, the bias
and the ReLU are applied in the epilogue before the one store.

``noisy_linear`` runs the kernel for CUDA tensors and ``noisy_linear_plain``
for CPU tensors.  The kernel takes bf16 operands only.

K3-bwd, its backward (``noisy_linear_bwd``, kernel ``csrc/noisy_linear_bwd.cu``,
plain twin ``noisy_linear_bwd_plain``), gives the cotangents that
``jax.grad`` gives the JAX layer, at the jaxpr's rounding points: each
cotangent of a bf16 operand is an fp32 product rounded once to bf16.  For
the learner's noisy hidden layers (M = 2048, K = 3136, N = 512) it is four
6.6 GFLOP products, ~27 us of bf16 tensor-core time: compute-bound.  The
kernel splits the fp32 dy into two bf16 halves so the tensor cores see it to
~2^-17, and runs each product on both (see the source for the design).
``NoisyLinearFn`` is the ``torch.autograd.Function`` over K3 and K3-bwd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K3_noisy_linear"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/noisy_linear.cu"
REPLACES = "rainbow_iqn_apex_tpu/models/layers.py:48"
NAME_BWD = NAME + "_bwd"
SOURCE_BWD = "rainbow_iqn_apex_tpu_torch/csrc/noisy_linear_bwd.cu"
REPLACES_BWD = "rainbow_iqn_apex_tpu/models/layers.py:48"


def noisy_linear_plain(x: torch.Tensor, w_mu: torch.Tensor, b_mu: torch.Tensor,
                       w_sigma: Optional[torch.Tensor] = None,
                       b_sigma: Optional[torch.Tensor] = None,
                       f_in: Optional[torch.Tensor] = None,
                       f_out: Optional[torch.Tensor] = None,
                       relu: bool = False) -> torch.Tensor:
    """x [M, K] and W [N, K] in the compute dtype, fp32 b/f vectors -> fp32
    [M, N].  Noisy iff ``w_sigma`` is given.  The operands are exact in fp32,
    so the fp32 products accumulate them as the JAX layer's dot does."""
    y = x.float() @ w_mu.float().t()
    b = b_mu
    if w_sigma is not None:
        xe = x * f_in.to(x.dtype)
        y = y + (xe.float() @ w_sigma.float().t()) * f_out
        b = b_mu + b_sigma * f_out
    y = y + b
    return torch.relu(y) if relu else y


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_noisy_linear
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def noisy_linear(x: torch.Tensor, w_mu: torch.Tensor, b_mu: torch.Tensor,
                 w_sigma: Optional[torch.Tensor] = None,
                 b_sigma: Optional[torch.Tensor] = None,
                 f_in: Optional[torch.Tensor] = None,
                 f_out: Optional[torch.Tensor] = None,
                 relu: bool = False) -> torch.Tensor:
    """K3 on ``x.device``: the kernel on CUDA, the plain twin on the CPU."""
    if x.device.type == "cpu":
        return noisy_linear_plain(x, w_mu, b_mu, w_sigma, b_sigma, f_in, f_out, relu)
    noisy = w_sigma is not None
    m, k = x.shape
    n = w_mu.shape[0]
    mats = (x, w_mu, w_sigma) if noisy else (x, w_mu)
    vecs = (b_mu, b_sigma, f_in, f_out) if noisy else (b_mu,)
    if any(t.dtype != torch.bfloat16 for t in mats):
        raise TypeError(
            "K3 takes bf16 x and weights (the CUDA path needs "
            "compute_dtype='bfloat16')")
    if any(t.dtype != torch.float32 for t in vecs):
        raise TypeError("K3 takes fp32 bias and noise vectors")
    shapes_ok = tuple(w_mu.shape) == (n, k) and tuple(b_mu.shape) == (n,)
    if noisy:
        shapes_ok = shapes_ok and tuple(w_sigma.shape) == (n, k) and tuple(
            b_sigma.shape) == (n,) and tuple(f_in.shape) == (k,) and tuple(
            f_out.shape) == (n,)
    if not shapes_ok:
        raise ValueError(f"K3 shape mismatch for x {tuple(x.shape)}, w {tuple(w_mu.shape)}")
    if k % 8:
        raise ValueError(f"K3 needs in_features % 8 == 0, got {k}")
    for t in (*mats, *vecs):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("K3 inputs must be contiguous on one device")
    if any(t.data_ptr() % 16 for t in mats):
        raise ValueError("K3 x and weights must be 16-byte aligned")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _entry()(
            build.ptr(x), build.ptr(w_mu), build.ptr(w_sigma), build.ptr(b_mu),
            build.ptr(b_sigma), build.ptr(f_in), build.ptr(f_out), build.ptr(y),
            m, n, k, int(relu), build.stream_of(x.device))
    build.check_launch(NAME, code)
    return y


def noisy_linear_bwd_plain(g: torch.Tensor, y: Optional[torch.Tensor], xc: torch.Tensor,
                           w_mu: torch.Tensor, w_sigma: Optional[torch.Tensor] = None,
                           f_in: Optional[torch.Tensor] = None,
                           f_out: Optional[torch.Tensor] = None):
    """Backward of K3 for g = dL/dy [M, N] fp32; ``y`` is the saved output
    of a ReLU layer (None without ReLU).  Returns (dxc, dW_mu, db_mu,
    dW_sigma, db_sigma): dxc and the weight cotangents in the compute dtype
    of ``xc``, the bias cotangents fp32; the sigma pair is None when greedy."""
    cdt = xc.dtype
    dy = g if y is None else torch.where(y > 0, g, torch.zeros_like(g))
    dxc = (dy @ w_mu.float()).to(cdt)
    dw_mu = (dy.t() @ xc.float()).to(cdt)
    db_mu = dy.sum(dim=0)
    if w_sigma is None:
        return dxc, dw_mu, db_mu, None, None
    dys = dy * f_out
    f_in_c = f_in.to(cdt)
    dxc = dxc + (dys @ w_sigma.float()).to(cdt) * f_in_c
    dw_sigma = (dys.t() @ (xc * f_in_c).float()).to(cdt)
    return dxc, dw_mu, db_mu, dw_sigma, f_out * db_mu


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = build.library().port_noisy_linear_bwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def noisy_linear_bwd(g: torch.Tensor, y: Optional[torch.Tensor], xc: torch.Tensor,
                     w_mu: torch.Tensor, w_sigma: Optional[torch.Tensor] = None,
                     f_in: Optional[torch.Tensor] = None,
                     f_out: Optional[torch.Tensor] = None):
    """K3-bwd on ``g.device``: the kernel on CUDA, the plain twin on the CPU."""
    if g.device.type == "cpu":
        return noisy_linear_bwd_plain(g, y, xc, w_mu, w_sigma, f_in, f_out)
    noisy = w_sigma is not None
    m, k = xc.shape
    n = w_mu.shape[0]
    mats = (xc, w_mu, w_sigma) if noisy else (xc, w_mu)
    vecs = (g,) + (() if y is None else (y,)) + ((f_in, f_out) if noisy else ())
    if any(t.dtype != torch.bfloat16 for t in mats):
        raise TypeError("K3-bwd takes bf16 x and weights")
    if any(t.dtype != torch.float32 for t in vecs):
        raise TypeError("K3-bwd takes fp32 dy, y and noise vectors")
    shapes_ok = (tuple(g.shape) == (m, n) and tuple(w_mu.shape) == (n, k)
                 and (y is None or tuple(y.shape) == (m, n)))
    if noisy:
        shapes_ok = shapes_ok and tuple(w_sigma.shape) == (n, k) and tuple(
            f_in.shape) == (k,) and tuple(f_out.shape) == (n,)
    if not shapes_ok:
        raise ValueError(f"K3-bwd shape mismatch for g {tuple(g.shape)}, x {tuple(xc.shape)}, "
                         f"w {tuple(w_mu.shape)}")
    if k % 8:
        raise ValueError(f"K3-bwd needs in_features % 8 == 0, got {k}")
    for t in (*mats, *vecs):
        if t.device != g.device or not t.is_contiguous():
            raise ValueError("K3-bwd inputs must be contiguous on one device")
    if any(t.data_ptr() % 16 for t in mats):
        raise ValueError("K3-bwd x and weights must be 16-byte aligned")
    dev = g.device
    n8 = (n + 7) // 8 * 8
    workspace = torch.empty(((4 if noisy else 2) * m * n8,), dtype=torch.bfloat16, device=dev)
    dxc = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
    dw_mu = torch.empty((n, k), dtype=torch.bfloat16, device=dev)
    db_mu = torch.empty((n,), dtype=torch.float32, device=dev)
    dw_sigma = torch.empty((n, k), dtype=torch.bfloat16, device=dev) if noisy else None
    db_sigma = torch.empty((n,), dtype=torch.float32, device=dev) if noisy else None
    with torch.cuda.device(dev):
        code = _bwd_entry()(
            build.ptr(g), build.ptr(y), build.ptr(xc), build.ptr(w_mu), build.ptr(w_sigma),
            build.ptr(f_in), build.ptr(f_out), build.ptr(dxc), build.ptr(dw_mu),
            build.ptr(dw_sigma), build.ptr(db_mu), build.ptr(db_sigma), build.ptr(workspace),
            m, n, k, build.stream_of(dev))
    build.check_launch(NAME_BWD, code)
    return dxc, dw_mu, db_mu, dw_sigma, db_sigma


class NoisyLinearFn(torch.autograd.Function):
    """K3 forward, K3-bwd backward: (xc, w_mu, b_mu, w_sigma, b_sigma, f_in,
    f_out, relu) -> y, differentiable in xc, the weights and the biases (the
    noise vectors get no gradient).  Greedy when ``w_sigma`` is None."""

    @staticmethod
    def forward(ctx, xc, w_mu, b_mu, w_sigma, b_sigma, f_in, f_out, relu):
        y = noisy_linear(xc, w_mu, b_mu, w_sigma, b_sigma, f_in, f_out, relu=relu)
        ctx.save_for_backward(xc, w_mu, w_sigma, f_in, f_out, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, g):
        xc, w_mu, w_sigma, f_in, f_out, y = ctx.saved_tensors
        dxc, dw_mu, db_mu, dw_sigma, db_sigma = noisy_linear_bwd(
            g.contiguous(), y, xc, w_mu, w_sigma, f_in, f_out)
        return dxc, dw_mu, db_mu, dw_sigma, db_sigma, None, None, None
