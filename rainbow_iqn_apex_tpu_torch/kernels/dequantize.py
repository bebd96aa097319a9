"""K10d: dequantize the quantized act path's small leaves in one launch.

Replaces the part of ``rainbow_iqn_apex_tpu/utils/quantize.py``
``dequantize_tree_jax`` (:219-236) that the NoisyLinear GEMM K10g does not
fuse: the three conv weights and biases and the tau embedding's weight and
bias, which XLA dequantizes inside the quantized act executable and the
layers then round to the compute dtype (``models/layers.py:121-158`` Dense
and Conv with ``dtype``):

    out = round(fp32(q) * s, dtype)    one scale per dim-0 row, or one

The conv and embedding weights go to the compute dtype (bf16 on the card),
as the flax layers cast them; the embedding bias stays fp32, because K2
rounds it itself.  cuDNN and K2 then run on these buffers unchanged.

Bound on the H100: 281,824 values at full width, ~0.28 MB of q and ~0.56 MB
of bf16 out, a fraction of a microsecond at 3.35 TB/s: launch-bound.  The
kernel (``csrc/dequantize.cu``) takes its table of leaves by value and runs
one thread per value.

``dequantize`` runs the kernel for CUDA tensors and ``dequantize_plain`` for
CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build
from rainbow_iqn_apex_tpu_torch.utils.quantize import dequantize_plain

NAME = "K10d_dequantize"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/dequantize.cu"
REPLACES = "rainbow_iqn_apex_tpu/utils/quantize.py:219"
MAX_SEGMENTS = 16  # csrc/dequantize.cu DTable

__all__ = ["dequantize", "dequantize_plain"]


class _Seg(ctypes.Structure):
    _fields_ = [("q", ctypes.c_void_p), ("s", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("start", ctypes.c_int), ("numel", ctypes.c_int), ("row_len", ctypes.c_int),
                ("per_row", ctypes.c_int), ("out_fp32", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_dequantize
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dequantize(qs: Sequence[torch.Tensor], ss: Sequence[torch.Tensor],
               outs: Sequence[torch.Tensor]) -> None:
    """K10d on the tensors' device, in place: ``outs[i] = qs[i] * ss[i]``
    rounded to ``outs[i].dtype`` (bf16 or fp32 on the card).  The kernel on
    CUDA, the twin on the CPU."""
    if not (len(qs) == len(ss) == len(outs)):
        raise ValueError("K10d: qs, ss and outs differ in length")
    if qs[0].device.type == "cpu":
        for q, s, out in zip(qs, ss, outs):
            out.copy_(dequantize_plain(q, s, out.dtype))
        return
    if len(qs) > MAX_SEGMENTS:
        raise ValueError(f"K10d takes at most {MAX_SEGMENTS} tensors, got {len(qs)}")
    qdt = qs[0].dtype
    if qdt not in (torch.int8, torch.float8_e4m3fn):
        raise TypeError(f"K10d takes int8 or float8_e4m3fn q, got {qdt}")
    dev = qs[0].device
    segs: List[_Seg] = []
    start = 0
    for q, s, out in zip(qs, ss, outs):
        if q.dtype != qdt or s.dtype != torch.float32:
            raise TypeError("K10d takes one q dtype and fp32 scales")
        if out.dtype not in (torch.bfloat16, torch.float32) or out.shape != q.shape:
            raise ValueError("K10d writes bf16 or fp32 outputs of q's shape")
        for t in (q, s, out):
            if t.device != dev or not t.is_contiguous():
                raise ValueError("K10d tensors must be contiguous on one device")
        if q.numel() % s.numel():
            raise ValueError(f"K10d: {s.numel()} scales do not divide {q.numel()} values")
        segs.append(_Seg(q.data_ptr(), s.data_ptr(), out.data_ptr(), start, q.numel(),
                         q.numel() // s.numel(), int(s.numel() > 1),
                         int(out.dtype == torch.float32)))
        start += q.numel()
    table = (_Seg * len(segs))(*segs)
    with torch.cuda.device(dev):
        code = _entry()(ctypes.cast(table, ctypes.c_void_p), len(segs),
                        int(qdt == torch.float8_e4m3fn), build.stream_of(dev))
    build.check_launch(NAME, code)
