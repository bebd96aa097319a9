"""K3: the factorised-noise NoisyLinear GEMM with its epilogue fused.

Replaces ``rainbow_iqn_apex_tpu/models/layers.py`` NoisyLinear.__call__
(:48-91) and the hidden ReLU of ``models/iqn.py`` (:85), which XLA fuses on
the TPU:

    greedy: y = x @ W_mu^T + b_mu
    noisy:  y = x @ W_mu^T + ((x * f_in) @ W_sigma^T) * f_out + b_mu + b_sigma * f_out

with f_in = f(eps_in), f_out = f(eps_out) and f(e) = sign(e) sqrt|e|, bf16
operands, fp32 accumulation, an fp32 bias and an fp32 output; ReLU after when
asked.  Weights are [N, K], torch's Linear layout.

Bound on the H100: each hidden layer at M = 2048 (K = 3136, N = 512) is 6.6
GFLOP a product, ~7 us at 989 TFLOP/s bf16, so operation-bound; the *_out
layers (N = 1, 18) are bound by the 2 MB of x and by the launch.  The kernel
(``csrc/noisy_linear.cu``) has two paths, one launch either way: N > 32 runs a
warp-specialised wgmma GEMM fed by TMA through an mbarrier ring, which in
noisy mode takes x * f_in as a register operand formed from the x tile
already in shared memory (x is read once; the [N, K] noise matrix is never
formed); N <= 32 runs an mma.sync kernel of 16 rows a block so that M fills
the card.  The noise scale, the bias and the ReLU are applied in the epilogue
before the one store.  ``forward_plan`` picks the path and the tile height.

``noisy_linear`` runs the kernel for CUDA tensors and ``noisy_linear_plain``
for CPU tensors.  The kernel takes bf16 operands only.

K3-bwd, its backward (``noisy_linear_bwd``, kernel ``csrc/noisy_linear_bwd.cu``,
plain twin ``noisy_linear_bwd_plain``), gives the cotangents that
``jax.grad`` gives the JAX layer, at the jaxpr's rounding points: each
cotangent of a bf16 operand is an fp32 product rounded once to bf16.  It
splits the fp32 dy into two bf16 halves so the tensor cores see it to ~2^-17,
and runs each product on both: for the learner's noisy hidden layers (M =
2048, K = 3136, N = 512) eight 6.6 GFLOP products, ~53 us of bf16
tensor-core time.  A prep pass writes the halves in both layouts, dx and dW
run as one wgmma GEMM with the bf16 matrix as a register operand, dW's depth
(M) split into chunks where its tiles alone would leave the card idle, and a
finalize pass sums the chunks in order (see the source for the design).
``backward_plan`` gives dW's tile width, the split and the workspace sizes.
``NoisyLinearFn`` is the ``torch.autograd.Function`` over K3 and K3-bwd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K3_noisy_linear"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/noisy_linear.cu"
REPLACES = "rainbow_iqn_apex_tpu/models/layers.py:48"
NAME_BWD = NAME + "_bwd"
SOURCE_BWD = "rainbow_iqn_apex_tpu_torch/csrc/noisy_linear_bwd.cu"
REPLACES_BWD = "rainbow_iqn_apex_tpu/models/layers.py:48"

SMS = 132  # streaming multiprocessors of the H100 SXM: the wave the plans fill
FULL_WAVE = 100  # output tiles from which one wave keeps the card busy enough
NARROW_N = 32  # K3's mma.sync path takes N up to this; wider layers run wgmma
TILE = 64  # rows of a wgmma tile and bf16 values of a TMA box row
BK_BWD = 128  # rows k of a K3-bwd GEMM block (two consumer warpgroups)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def forward_plan(m: int, n: int) -> int:
    """K3's path for an [m, k] x [n, k]^T product: 0 is the narrow mma.sync
    kernel (N <= 32, 16 rows a block), else the consumer warpgroups of a
    wgmma tile of (64 * that) x 64: two where that still gives a full wave."""
    if n <= NARROW_N:
        return 0
    return 2 if _cdiv(m, 2 * TILE) * _cdiv(n, TILE) >= FULL_WAVE else 1


class BackwardPlan(NamedTuple):
    bn_w: int  # dW's tile width over n: 8, 24 or 64
    splits: int  # S: chunks of dW's depth M; chunk c is depth tiles [c T / S, (c + 1) T / S)
    ws_bf16: int  # bf16 values of the dy planes: [5 / 2, M, N8] (dx) then [4 / 2, N8, MP] (dW)
    ws_f32: int  # fp32 values of the column sums [MP / 32, N], then dW's partials


@functools.lru_cache(maxsize=256)
def backward_plan(m: int, n: int, k: int, noisy: bool) -> BackwardPlan:
    """K3-bwd's launch plan (``csrc/noisy_linear_bwd.cu``).  dW's output
    tiles are BK_BWD rows k by bn_w columns n; where they number fewer than a
    full wave, dW's depth (m_tiles tiles of 64 rows of M) is split into S
    chunks so that tiles x S fills the 132 SMs, and the chunks' fp32 partials
    are summed in order by the finalize pass."""
    n8, mp = _cdiv(n, 8) * 8, _cdiv(m, 8) * 8
    planes = 4 if noisy else 2  # dy hi, lo (, dys hi, lo); dx's P adds dys lo2
    p_planes = 5 if noisy else 2
    bn_w = 8 if n8 <= 8 else 24 if n8 <= 24 else TILE
    m_tiles = _cdiv(m, TILE)
    tiles = _cdiv(k, BK_BWD) * _cdiv(n, bn_w)
    splits = 1 if tiles >= FULL_WAVE else min(m_tiles, _cdiv(SMS, tiles))
    partials = (2 if noisy else 1) * splits * n * k if splits > 1 else 0
    return BackwardPlan(bn_w, splits, ws_bf16=p_planes * m * n8 + planes * n8 * mp,
                        ws_f32=_cdiv(mp, 32) * n + partials)


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
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
            m, n, k, int(relu), forward_plan(m, n), build.stream_of(x.device))
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
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    plan = backward_plan(m, n, k, noisy)
    f32_at = _cdiv(2 * plan.ws_bf16, 256) * 256  # one allocation: bf16 planes, then fp32
    workspace = torch.empty((f32_at + 4 * plan.ws_f32,), dtype=torch.uint8, device=dev)
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
            ctypes.c_void_p(workspace.data_ptr() + f32_at), m, n, k, plan.bn_w, plan.splits,
            build.stream_of(dev))
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
