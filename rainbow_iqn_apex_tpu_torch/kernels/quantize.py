"""K10q: quantize every parameter of a network in one launch.

Replaces ``rainbow_iqn_apex_tpu/utils/quantize.py`` ``quantize_tree_jax``
(:173-192) and ``cast_tree_fp8`` (:195-208), which XLA fuses on the TPU:

    int8: s = max|w| * fp32(1/127) per row (1 for an all-zero row),
          q = clip(rint(w / s), -127, 127)
    fp8:  q = e4m3(w), s = 1; |w| > 464 and NaN give NaN, [448, 464] -> 448

A "row" is one output channel (dim 0) of a rank >= 2 parameter in int8
mode, or the whole tensor (a bias; every parameter in fp8 mode, whose rows
are only a split of the work).  The scale is a product: XLA's algebraic
simplifier turns the JAX source's ``max_abs / 127`` (a division by a
constant) into ``max_abs * 0.00787401572``, which differs from the IEEE
quotient by an ulp for some rows.  ``w / s`` stays an IEEE division
(``__fdiv_rn``) and ``rint`` rounds half to even, so q and s are bit-equal
to the JAX package's.

Bound on the H100: the full-width tree is 6,725,894 parameters, 26.9 MB of
fp32 read and 6.73 MB of q written, ~10 us at 3.35 TB/s.  The kernel
(``csrc/quantize.cu``) takes a table of every parameter by value (no
upload, so it can run inside a no-sync region and a CUDA graph) and runs
one block per row: a max-abs reduction, then the quantize pass over the row
it just read (from L2).  It runs once per staged or published tree.

``quantize`` runs the kernel for CUDA tensors and ``quantize_plain`` per
tensor for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K10q_quantize"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/quantize.cu"
REPLACES = "rainbow_iqn_apex_tpu/utils/quantize.py:173"
MAX_SEGMENTS = 32  # csrc/quantize.cu QTable
_INT8_MAX = 127.0
_INV_INT8_MAX = 1.0 / 127.0  # the fp32 constant XLA multiplies by
FP8_NAN_ABOVE = 464.0  # e4m3's largest finite 448 plus half its ulp


class _Seg(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("q", ctypes.c_void_p), ("s", ctypes.c_void_p),
                ("rows", ctypes.c_int), ("cols", ctypes.c_int), ("row0", ctypes.c_int),
                ("per_row", ctypes.c_int)]


def fp8_cast_plain(w: torch.Tensor) -> torch.Tensor:
    """e4m3 of fp32 ``w`` with JAX's (ml_dtypes') overflow rule: torch's
    cast saturates, so |w| > 464, inf and NaN are set to NaN (0x7f with
    w's sign) after it."""
    q = w.to(torch.float8_e4m3fn).view(torch.uint8)
    bad = ~(w.abs() <= FP8_NAN_ABOVE)
    nan = torch.where(torch.signbit(w), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(bad, nan, q).view(torch.float8_e4m3fn)


def quantize_plain(w: torch.Tensor, mode: str, rows: int):
    """fp32 ``w`` -> (q in ``w``'s shape, s fp32 [rows]): ``rows`` scales
    over dim 0 (1: one for the tensor) in int8 mode; s = [1.] in fp8."""
    w = w.to(torch.float32)
    if mode == "fp8":
        return fp8_cast_plain(w), torch.ones(1, dtype=torch.float32, device=w.device)
    flat = w.reshape(rows, -1)
    max_abs = flat.abs().amax(dim=1)
    scale = torch.where(max_abs > 0, max_abs * _INV_INT8_MAX, torch.ones_like(max_abs))
    q = torch.clamp(torch.round(flat / scale[:, None]), -_INT8_MAX, _INT8_MAX)
    return q.to(torch.int8).reshape(w.shape), scale


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_quantize
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize(srcs: Sequence[torch.Tensor], qs: Sequence[torch.Tensor],
             ss: Sequence[torch.Tensor], mode: str) -> None:
    """K10q on the tensors' device, in place: each fp32 ``srcs[i]`` into
    ``qs[i]`` (int8 or float8_e4m3fn, its shape) and ``ss[i]`` (fp32, one
    scale per dim-0 row or one).  The kernel on CUDA, the twin on the CPU."""
    if mode not in ("int8", "fp8"):
        raise ValueError(f"K10q: no quantized payload for mode {mode!r}")
    if not (len(srcs) == len(qs) == len(ss)):
        raise ValueError("K10q: srcs, qs and ss differ in length")
    if srcs[0].device.type == "cpu":
        for w, q, s in zip(srcs, qs, ss):
            q_new, s_new = quantize_plain(w, mode, s.numel())
            q.copy_(q_new)
            s.copy_(s_new)
        return
    qdt = torch.int8 if mode == "int8" else torch.float8_e4m3fn
    dev = srcs[0].device
    if len(srcs) > MAX_SEGMENTS:
        raise ValueError(f"K10q takes at most {MAX_SEGMENTS} tensors, got {len(srcs)}")
    segs: List[_Seg] = []
    row0 = 0
    for w, q, s in zip(srcs, qs, ss):
        if w.dtype != torch.float32 or q.dtype != qdt or s.dtype != torch.float32:
            raise TypeError(f"K10q ({mode}) takes fp32 sources, {qdt} q and fp32 scales")
        if q.shape != w.shape:
            raise ValueError(f"K10q: q {tuple(q.shape)} differs from w {tuple(w.shape)}")
        for t in (w, q, s):
            if t.device != dev or not t.is_contiguous():
                raise ValueError("K10q tensors must be contiguous on one device")
        per_row = mode == "int8" and s.numel() > 1
        rows = w.shape[0] if w.dim() >= 2 else 1
        if mode == "int8" and s.numel() not in (1, rows):
            raise ValueError(f"K10q: {s.numel()} scales for {rows} rows")
        if mode == "int8" and not per_row:
            rows = 1  # one scale: the whole tensor is one row
        cols = w.numel() // rows
        segs.append(_Seg(w.data_ptr(), q.data_ptr(), s.data_ptr(), rows, cols, row0,
                         int(per_row)))
        row0 += rows
    table = (_Seg * len(segs))(*segs)
    with torch.cuda.device(dev):
        code = _entry()(ctypes.cast(table, ctypes.c_void_p), len(segs),
                        int(mode == "fp8"), build.stream_of(dev))
    build.check_launch(NAME, code)
