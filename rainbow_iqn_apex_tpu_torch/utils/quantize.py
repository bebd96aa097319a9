"""Quantized policy weights: symmetric per-channel int8 or an fp8 (e4m3)
cast, and the greedy-action agreement gate that decides whether they serve.

Counterpart of ``rainbow_iqn_apex_tpu/utils/quantize.py`` (:1-247).  The
numpy half is a copy (``QUANT_MODES``, ``check_mode``, the tree plumbing,
``quantize_array`` / ``dequantize_array``, ``quantize_tree`` /
``dequantize_tree``, ``is_quantized_tree``, ``greedy_agreement``); the jax
twins become torch functions on the port's state dicts:

- ``quantize_params(params, mode)`` (``quantize_tree_jax`` /
  ``cast_tree_fp8``) returns a ``QuantizedParams``: the kernel K10q on the
  card (``kernels/quantize.py``), its plain twin on the CPU;
- ``dequantize_params_plain(qp)`` (``dequantize_tree_jax``) gives fp32
  ``q * s`` per parameter;
- the act path on a ``QuantizedParams`` (``wrap_act_quantized``) is
  ``models/quantized.py:QuantizedIQN``.

Layout.  ``QuantizedParams`` holds ``(q, s)`` per parameter name of the
port's ``RainbowIQN`` state dict, in the port's layout.  In int8 mode a
rank >= 2 parameter has one scale per output channel, dim 0 of a Linear
weight [out, in], of a Conv2d weight [cout, cin, kh, kw] and of the
embedding's [F, C] (JAX's last axis of the transposed flax kernel: the same
numbers); a bias has one scale for the whole tensor.  In fp8 mode every
parameter has one scale, 1, as ``cast_tree_fp8`` stores it.  Each ``q``
lives in one flat byte buffer (each parameter at a 16-byte boundary, so a
kernel can load it in 16-byte chunks) and each ``s`` in one flat fp32
buffer, so a publish moves two tensors.

fp8 needs ``torch.float8_e4m3fn`` (``fp8_available``), not ``ml_dtypes``.
The cast keeps JAX's overflow rule, which ``tensor.to(float8_e4m3fn)`` does
not (it saturates): |x| > 464 and NaN give NaN, [448, 464] rounds to 448.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

QUANT_MODES = ("off", "int8", "fp8")
_INT8_MAX = 127.0
_ALIGN = 16  # bytes: each parameter's q starts at a 16-byte boundary


def fp8_available() -> bool:
    """fp8 serving needs torch's float8_e4m3fn dtype."""
    return hasattr(torch, "float8_e4m3fn")


def check_mode(mode: str) -> str:
    if mode not in QUANT_MODES:
        raise ValueError(f"serve_quantize must be one of {QUANT_MODES}, "
                         f"got {mode!r}")
    if mode == "fp8" and not fp8_available():
        raise ValueError("serve_quantize='fp8' needs torch.float8_e4m3fn "
                         "(not available in this torch)")
    return mode


# ------------------------------------------------------------ tree plumbing
def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            out.update(flatten_tree(tree[key], f"{prefix}{key}/"))
        return out
    out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return root


def tree_bytes(tree: Any) -> int:
    """Logical payload bytes of a pytree (what a publish would ship)."""
    return int(sum(leaf.nbytes for leaf in flatten_tree(tree).values()))


# -------------------------------------------------- symmetric int8 (numpy)
def quantize_array(arr: np.ndarray,
                   per_channel: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8: returns (q int8, scale f32).  Rank>=2 arrays get one
    scale per OUTPUT channel (last axis, the flax kernel convention); rank
    0/1 arrays one per-tensor scale.  An all-zero channel gets scale 1."""
    arr = np.asarray(arr, np.float32)
    if per_channel and arr.ndim >= 2:
        axes = tuple(range(arr.ndim - 1))
        max_abs = np.max(np.abs(arr), axis=axes)  # [C]
    else:
        max_abs = np.max(np.abs(arr)) if arr.size else np.float32(0.0)
    scale = np.where(max_abs > 0, max_abs / _INT8_MAX, 1.0).astype(np.float32)
    q = np.clip(np.rint(arr / scale), -_INT8_MAX, _INT8_MAX).astype(np.int8)
    return q, np.atleast_1d(scale)


def dequantize_array(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    scale = np.asarray(scale, np.float32)
    if scale.size == 1:
        scale = scale.reshape(())
    return (q.astype(np.float32) * scale).astype(np.float32)


def quantize_tree(tree: Any, per_channel: bool = True) -> Dict[str, Any]:
    """Pytree -> same-shape pytree with each leaf replaced by
    ``{"q": int8, "s": f32 scale}``."""
    flat = flatten_tree(tree)
    qflat = {}
    for path, leaf in flat.items():
        q, s = quantize_array(leaf, per_channel=per_channel)
        qflat[path] = {"q": q, "s": s}
    return unflatten_tree(qflat)


def dequantize_tree(qtree: Any) -> Dict[str, Any]:
    """Inverse of `quantize_tree` (numpy)."""
    def walk(node):
        if isinstance(node, Mapping) and set(node) == {"q", "s"}:
            return dequantize_array(np.asarray(node["q"]), np.asarray(node["s"]))
        return {k: walk(v) for k, v in node.items()}

    return walk(qtree)


def is_quantized_tree(tree: Any) -> bool:
    """True when ``tree`` is a `quantize_tree` output (its leaves are
    {"q","s"} cells)."""
    node = tree
    while isinstance(node, Mapping):
        if set(node) == {"q", "s"}:
            return True
        if not node:
            return False
        node = node[sorted(node)[0]]
    return False


def greedy_agreement(actions_a: np.ndarray, actions_b: np.ndarray) -> float:
    """Fraction of identical greedy actions: the accuracy gate's metric."""
    a = np.asarray(actions_a).reshape(-1)
    b = np.asarray(actions_b).reshape(-1)
    if a.shape != b.shape:
        raise ValueError(f"action shape mismatch {a.shape} vs {b.shape}")
    if a.size == 0:
        return 0.0
    return float(np.mean(a == b))


# ------------------------------------------------------- torch state dicts
def q_dtype(mode: str) -> torch.dtype:
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"no quantized payload for mode {mode!r}")


def scale_count(shape: Tuple[int, ...], mode: str) -> int:
    """Scales of one parameter: its output channels (dim 0) for a rank >= 2
    parameter in int8 mode, else one."""
    return int(shape[0]) if mode == "int8" and len(shape) >= 2 else 1


class QuantizedParams:
    """``(q, s)`` per parameter name, in the port's layout, on one device.

    ``q[name]`` has the parameter's shape and dtype int8 or float8_e4m3fn;
    ``s[name]`` is fp32 [scale_count].  Both are views into ``q_flat``
    (uint8) and ``s_flat`` (fp32), which a copy moves whole.
    """

    def __init__(self, mode: str, shapes: Mapping[str, Tuple[int, ...]],
                 device: Union[str, torch.device] = "cpu"):
        self.mode = check_mode(mode)
        qdt = q_dtype(mode)
        self.shapes = {name: tuple(int(d) for d in shape) for name, shape in shapes.items()}
        q_off, s_off, q_total, s_total = {}, {}, 0, 0
        for name, shape in self.shapes.items():
            q_off[name], s_off[name] = q_total, s_total
            q_total += -(-int(np.prod(shape, dtype=np.int64)) // _ALIGN) * _ALIGN
            s_total += scale_count(shape, mode)
        self.q_flat = torch.zeros(max(q_total, 1), dtype=torch.uint8, device=device)
        self.s_flat = torch.ones(max(s_total, 1), dtype=torch.float32, device=device)
        self.q: Dict[str, torch.Tensor] = {}
        self.s: Dict[str, torch.Tensor] = {}
        for name, shape in self.shapes.items():
            n = int(np.prod(shape, dtype=np.int64))
            self.q[name] = self.q_flat[q_off[name]:q_off[name] + n].view(qdt).view(shape)
            k = scale_count(shape, mode)
            self.s[name] = self.s_flat[s_off[name]:s_off[name] + k]

    @classmethod
    def like(cls, params: Mapping[str, torch.Tensor], mode: str,
             device: Optional[Union[str, torch.device]] = None) -> "QuantizedParams":
        """Empty buffers for ``params``' names and shapes."""
        first = next(iter(params.values()))
        return cls(mode, {k: tuple(v.shape) for k, v in params.items()},
                   first.device if device is None else device)

    @property
    def device(self) -> torch.device:
        return self.q_flat.device

    def wire_bytes(self) -> int:
        """Bytes a publish of these weights ships: every q byte and every
        fp32 scale (JAX's ``_tree_wire_bytes`` of the {"q","s"} tree)."""
        return int(sum(t.numel() for t in self.q.values())
                   + 4 * sum(t.numel() for t in self.s.values()))

    def copy_(self, other: "QuantizedParams") -> "QuantizedParams":
        """In place: ``other``'s q and s into these buffers (same layout)."""
        if other.mode != self.mode or other.shapes != self.shapes:
            raise ValueError("QuantizedParams.copy_ needs the same mode and shapes")
        self.q_flat.copy_(other.q_flat, non_blocking=True)
        self.s_flat.copy_(other.s_flat, non_blocking=True)
        return self

    def to(self, device: Union[str, torch.device]) -> "QuantizedParams":
        out = QuantizedParams(self.mode, self.shapes, device)
        out.q_flat.copy_(self.q_flat)
        out.s_flat.copy_(self.s_flat)
        return out


def _named(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return {k: v.detach() for k, v in params.named_parameters()}
    return {k: v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            for k, v in params.items()}


def quantize_params(params: Union[nn.Module, Mapping[str, torch.Tensor]], mode: str,
                    out: Optional[QuantizedParams] = None) -> QuantizedParams:
    """Quantize fp32 ``params`` (a state dict or a module's parameters) in
    ``mode`` into ``out`` (new buffers on the parameters' device when None):
    K10q, one launch for every parameter, on the card; its twin on the CPU.
    The counterpart of ``quantize_for_mode`` over ``quantize_tree_jax`` /
    ``cast_tree_fp8``."""
    from rainbow_iqn_apex_tpu_torch.kernels.quantize import quantize

    named = _named(params)
    if out is None:
        out = QuantizedParams.like(named, mode)
    elif out.mode != check_mode(mode):
        raise ValueError(f"out holds {out.mode} weights, asked for {mode}")
    if set(named) != set(out.shapes):
        raise ValueError("quantize_params: parameter names differ from out's")
    names = list(out.shapes)
    quantize([named[n] for n in names], [out.q[n] for n in names],
             [out.s[n] for n in names], mode)
    return out


def quantize_for_mode(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                      mode: str) -> QuantizedParams:
    if mode not in ("int8", "fp8"):
        raise ValueError(f"no quantized payload for mode {mode!r}")
    return quantize_params(params, mode)


def dequantize_plain(q: torch.Tensor, s: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * s`` as JAX's ``dequantize_tree_jax`` computes it (an fp32
    product, one scale per dim-0 row or one for the tensor), then rounded
    to ``dtype`` as the layer that reads it rounds."""
    rows = s.numel()
    w = q.to(torch.float32).reshape(rows, -1) * s.reshape(rows, 1)
    return w.reshape(q.shape).to(dtype)


def dequantize_params_plain(qp: QuantizedParams) -> Dict[str, torch.Tensor]:
    """fp32 ``q * s`` per parameter: the port's ``dequantize_tree_jax``."""
    return {name: dequantize_plain(qp.q[name], qp.s[name]) for name in qp.shapes}

