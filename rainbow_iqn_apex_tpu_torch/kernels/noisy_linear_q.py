"""K10g: the weight-only quantized NoisyLinear GEMM (int8 or e4m3 weights).

Replaces the quantized act path of ``rainbow_iqn_apex_tpu/utils/quantize.py``
(``dequantize_tree_jax`` :219-236 under ``wrap_act_quantized`` :239-247)
fused by XLA into ``models/layers.py`` NoisyLinear.__call__ (:71-91):

    W = bf16(fp32(q_W) * s_W)    one scale per output row (int8) or one (fp8)
    b = fp32(q_b) * s_b          one scale per bias
    greedy: y = x @ W_mu^T + b_mu
    noisy:  y = x @ W_mu^T + ((x * f_in) @ W_sigma^T) * f_out + b_mu + b_sigma * f_out

then ReLU when asked: K3 (``kernels/noisy_linear.py``) on the weights the
JAX dot sees.  x is bf16, the output fp32.  The scale is applied to each
weight before the product, not to the product's sum ((x @ q) * s rounds
differently from the JAX graph); the activations are not quantized.

Bound on the H100: the products of K3 (6.6 GFLOP per serving hidden layer
at M = 2048, K = 3136, N = 512, ~6.7 us of bf16 tensor-core time), with one
byte per weight read: operation-bound; the *_out layers are bound by x's
bytes and the launch.  The kernel (``csrc/noisy_linear_q.cu``), one launch a
layer either way: N > 32 runs a TMA-fed wgmma GEMM with the operands swapped
(y^T = W x^T): each consumer warpgroup turns its 64 weight rows' raw bytes
into bf16 register fragments (the A operand) and x is the shared-memory B
operand, so converted weights never go through shared memory (a tile is
128 weight rows by 128 tokens greedy, 64 noisy); its k range is split in
order over a thread-block cluster where the tiles alone would leave the
card idle (``forward_plan``); N <= 32 runs K3's mma.sync kernel with the B
fragments built in registers from the bytes.  What holds it back:
converting the weights on the consumers' issue slots, again for each tile
of tokens (the tensor cores wait on it).

``noisy_linear_q`` runs the kernel for CUDA tensors and
``noisy_linear_q_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build
from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear import (
    FULL_WAVE,
    NARROW_N,
    SMS,
    noisy_linear_plain,
)
from rainbow_iqn_apex_tpu_torch.utils.quantize import dequantize_plain

NAME = "K10g_noisy_linear_q"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/noisy_linear_q.cu"
REPLACES = "rainbow_iqn_apex_tpu/utils/quantize.py:239"
TILE_W, TILE_K = 128, 128  # a wide block's weight rows and k step
TILE_T = {False: 128, True: 64}  # its tokens, greedy and noisy
MAX_SPLITS = 8  # blocks of a portable cluster


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def forward_plan(m: int, n: int, k: int, noisy: bool, clusters: Tuple[int, ...]) -> int:
    """K10g's path for an [m, k] x [n, k]^T product: 0 is the narrow mma.sync
    kernel (N <= 32), else the blocks of one cluster that split each wide
    tile's (128 weight rows x ``TILE_T[noisy]`` tokens) k range in order: 1
    where the tiles fill a wave, else the most (up to 8, and one a k step)
    whose clusters all fit on the card at once (``clusters[s - 1]``: how many
    clusters of s blocks it holds, the occupancy query) within its SMs."""
    if n <= NARROW_N:
        return 0
    tiles = _cdiv(m, TILE_T[noisy]) * _cdiv(n, TILE_W)
    splits = 1
    if tiles < FULL_WAVE:
        for s in range(2, min(MAX_SPLITS, _cdiv(k, TILE_K)) + 1):
            if tiles * s <= SMS and tiles <= clusters[s - 1]:
                splits = s
    return splits


@functools.lru_cache(maxsize=None)
def max_clusters(index: int, noisy: bool) -> Tuple[int, ...]:
    """How many clusters of 1 .. 8 wide K10g blocks the card ``index`` runs
    at once (the occupancy query; 0 where it cannot say)."""
    fn = build.library().port_noisy_linear_q_max_clusters
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    with torch.cuda.device(index):
        return tuple(int(fn(s, int(noisy))) for s in range(1, MAX_SPLITS + 1))


def noisy_linear_q_plain(x: torch.Tensor, qw_mu: torch.Tensor, sw_mu: torch.Tensor,
                         qb_mu: torch.Tensor, sb_mu: torch.Tensor,
                         qw_sigma: Optional[torch.Tensor] = None,
                         sw_sigma: Optional[torch.Tensor] = None,
                         qb_sigma: Optional[torch.Tensor] = None,
                         sb_sigma: Optional[torch.Tensor] = None,
                         f_in: Optional[torch.Tensor] = None,
                         f_out: Optional[torch.Tensor] = None,
                         relu: bool = False) -> torch.Tensor:
    """x [M, K] in the compute dtype, q [N, K] / [N] with their fp32 scales
    -> fp32 [M, N]: the weights dequantized and rounded as the JAX layer
    rounds them, then K3's plain twin.  Noisy iff ``qw_sigma`` is given."""
    cdt = x.dtype
    w_mu, b_mu = dequantize_plain(qw_mu, sw_mu, cdt), dequantize_plain(qb_mu, sb_mu)
    if qw_sigma is None:
        return noisy_linear_plain(x, w_mu, b_mu, relu=relu)
    w_sigma, b_sigma = dequantize_plain(qw_sigma, sw_sigma, cdt), dequantize_plain(qb_sigma,
                                                                                   sb_sigma)
    return noisy_linear_plain(x, w_mu, b_mu, w_sigma, b_sigma, f_in, f_out, relu)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_noisy_linear_q
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def noisy_linear_q(x: torch.Tensor, qw_mu: torch.Tensor, sw_mu: torch.Tensor,
                   qb_mu: torch.Tensor, sb_mu: torch.Tensor,
                   qw_sigma: Optional[torch.Tensor] = None,
                   sw_sigma: Optional[torch.Tensor] = None,
                   qb_sigma: Optional[torch.Tensor] = None,
                   sb_sigma: Optional[torch.Tensor] = None,
                   f_in: Optional[torch.Tensor] = None,
                   f_out: Optional[torch.Tensor] = None,
                   relu: bool = False) -> torch.Tensor:
    """K10g on ``x.device``: the kernel on CUDA, the plain twin on the CPU."""
    if x.device.type == "cpu":
        return noisy_linear_q_plain(x, qw_mu, sw_mu, qb_mu, sb_mu, qw_sigma, sw_sigma,
                                    qb_sigma, sb_sigma, f_in, f_out, relu)
    noisy = qw_sigma is not None
    m, k = x.shape
    n = qw_mu.shape[0]
    qdt = qw_mu.dtype
    if qdt not in (torch.int8, torch.float8_e4m3fn):
        raise TypeError(f"K10g takes int8 or float8_e4m3fn weights, got {qdt}")
    if x.dtype != torch.bfloat16:
        raise TypeError("K10g takes bf16 x (the CUDA path needs compute_dtype='bfloat16')")
    qs = (qw_mu, qb_mu, qw_sigma, qb_sigma) if noisy else (qw_mu, qb_mu)
    vecs = (sw_mu, sb_mu, sw_sigma, sb_sigma, f_in, f_out) if noisy else (sw_mu, sb_mu)
    if any(t.dtype != qdt for t in qs) or any(t.dtype != torch.float32 for t in vecs):
        raise TypeError("K10g takes one q dtype and fp32 scales and noise vectors")
    per_row = sw_mu.numel() > 1
    rows = n if per_row else 1
    shapes_ok = (tuple(qw_mu.shape) == (n, k) and tuple(qb_mu.shape) == (n,)
                 and sw_mu.numel() == rows and sb_mu.numel() == 1)
    if noisy:
        shapes_ok = shapes_ok and tuple(qw_sigma.shape) == (n, k) and tuple(
            qb_sigma.shape) == (n,) and sw_sigma.numel() == rows and sb_sigma.numel() == 1 \
            and tuple(f_in.shape) == (k,) and tuple(f_out.shape) == (n,)
    if not shapes_ok:
        raise ValueError(f"K10g shape mismatch for x {tuple(x.shape)}, q {tuple(qw_mu.shape)}")
    if k % 16:
        raise ValueError(f"K10g needs in_features % 16 == 0, got {k}")
    for t in (x, *qs, *vecs):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("K10g inputs must be contiguous on one device")
    if any(t.data_ptr() % 16 for t in (x, qw_mu, qw_sigma) if t is not None):
        raise ValueError("K10g x and weights must be 16-byte aligned")
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    splits = forward_plan(m, n, k, noisy, max_clusters(index, noisy))
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    p = build.ptr
    with torch.cuda.device(x.device):
        code = _entry()(
            p(x), p(qw_mu), p(sw_mu), p(qb_mu), p(sb_mu), p(qw_sigma), p(sw_sigma),
            p(qb_sigma), p(sb_sigma), p(f_in), p(f_out), p(y), m, n, k, int(relu),
            int(per_row), int(qdt == torch.float8_e4m3fn), splits, build.stream_of(x.device))
    build.check_launch(NAME, code)
    return y
