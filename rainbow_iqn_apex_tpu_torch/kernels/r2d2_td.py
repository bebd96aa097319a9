"""K11: the R2D2 TD and priority epilogue (loss, priorities, q mean and the
loss's gradient in q_taken) in one launch, with K6s's write-back folded in
on the R2D2 Anakin step.

Replaces the ``loss_fn`` of ``rainbow_iqn_apex_tpu/ops/r2d2.py``
``build_r2d2_learn_step`` (:196-260) with ``value_rescale`` /
``value_unrescale`` (:33-43): the double-Q bootstrap through h^-1, the
n-step windowed return cut at terminals, y = h(R + gamma^n alive q_boot),
the valid / target-ok mask, the masked Huber(1) summed per sequence over the
mask count, IS-weighted and averaged over B, and the priorities eta max|td|
+ (1 - eta) mean|td|.  Launch-bound (~0.4 MB); the kernel
(``csrc/r2d2_td.cu``) runs one warp a sequence, its blocks (``td_plan``)
one cluster that sums into block 0.  ``reward``, ``done`` and ``valid`` may be column slices of the
batch's [B, L] rows (unit column stride): the kernel reads them in place.

Given a ``replay_writeback.Writeback`` target (the device sequence ring's
priorities, ``max_priority`` and the draws' ids [G, B / G]), the launch also
does K6s's write-back of the priorities it computes (the unfenced scatter,
``seq_writeback``), so the R2D2 Anakin step launches no K6s of its own.

``r2d2_td`` runs the kernel for CUDA tensors and ``r2d2_td_plain`` (then,
with a target, ``seq_writeback_plain``) for CPU tensors; ``R2D2TDFn`` is the
``torch.autograd.Function`` whose backward scales the kernel's d loss /
d q_taken by the incoming gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.kernels import build
from rainbow_iqn_apex_tpu_torch.kernels.replay_writeback import Writeback
from rainbow_iqn_apex_tpu_torch.kernels.seq_writeback import NAME as K6S_NAME
from rainbow_iqn_apex_tpu_torch.kernels.seq_writeback import seq_writeback_plain

NAME = "K11_r2d2_td"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/r2d2_td.cu"
REPLACES = "rainbow_iqn_apex_tpu/ops/r2d2.py:196"
MAX_SEQS = 32  # sequences a block, a warp each
MAX_CLUSTER = 16  # blocks of the cluster
MAX_STEPS = 256  # T: at most 8 steps a lane
SMEM_LIMIT = 225 * 1024  # the kernel's dynamic shared memory ceiling


class TDParams(NamedTuple):
    """The step's constants as the config gives them (Python floats).  The
    kernel takes gamma ** n, 1 - eta, 4 eps and 2 eps each rounded to fp32
    from double, as JAX folds the source's Python-float expressions."""

    n: int
    gamma: float
    eta: float
    eps: float


def value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """h(x) = sign(x) * (sqrt(|x| + 1) - 1) + eps * x."""
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def value_unrescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """h^-1, the closed form of the R2D2 appendix."""
    inner = torch.sqrt(1.0 + (4.0 * eps) * (torch.abs(x) + 1.0 + eps)) - 1.0
    r = inner / (2.0 * eps)
    return torch.sign(x) * (r * r - 1.0)


def _huber(u: torch.Tensor) -> torch.Tensor:
    a = torch.abs(u)
    return torch.where(a <= 1.0, 0.5 * (u * u), a - 0.5)


def r2d2_td_plain(q_taken, q_sel, q_tgt, reward, done, valid, weight, p: TDParams):
    """q_taken [B, T], q_sel / q_tgt [B, T, A], reward [B, T] fp32, done /
    valid [B, T] bool, weight [B] -> (loss [], priorities [B], q_mean [],
    d loss / d q_taken [B, T])."""
    batch, steps = q_taken.shape
    n, tn = p.n, steps - p.n
    f32 = torch.float32
    d, v = done.to(f32), valid.to(f32)
    a_star = torch.argmax(q_sel, dim=-1, keepdim=True)
    q_boot = value_unrescale(torch.gather(q_tgt, 2, a_star)[..., 0], p.eps)
    rn = torch.zeros((batch, tn), dtype=f32, device=q_taken.device)
    alive = torch.ones_like(rn)
    dsum = torch.zeros_like(rn)
    gk = 1.0
    for k in range(n):
        dk = d[:, k:k + tn]
        rn = rn + reward[:, k:k + tn] * alive * gk
        alive = alive * (1.0 - dk)
        gk = float(np.float32(gk * np.float32(p.gamma)))  # the kernel's fp32 product
        dsum = dsum + dk
    done_w = torch.clamp(dsum, 0.0, 1.0)
    y = value_rescale(rn + p.gamma ** n * (1.0 - done_w) * q_boot[:, n:], p.eps)
    mask = v[:, :tn] * torch.clamp(done_w + v[:, n:], 0.0, 1.0)
    td = (y - q_taken[:, :tn]) * mask
    denom = torch.clamp(mask.sum(dim=1), min=1.0)
    per_seq = _huber(td).sum(dim=1) / denom
    loss = torch.mean(weight * per_seq)
    abs_td = torch.abs(td)
    priorities = p.eta * abs_td.max(dim=1).values + (1.0 - p.eta) * (abs_td.sum(dim=1) / denom)
    q_mean = (q_taken * v).sum() / torch.clamp(v.sum(), min=1.0)
    grad = torch.zeros_like(q_taken)
    grad[:, :tn] = -(weight / batch)[:, None] / denom[:, None] * torch.clamp(td, -1.0, 1.0) * mask
    return loss, priorities, q_mean, grad


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def seq_bytes(steps: int, actions: int) -> int:
    """A sequence's shared memory in the kernel (``csrc/r2d2_td.cu``:
    seq_bytes): its q_sel and q_tgt rows, then q_boot, rewards, dones and
    valids."""
    return 2 * _align16(4 * steps * actions) + _align16(10 * steps)


def td_plan(rows: int, steps: int, actions: int) -> tuple:
    """(sequences a block, blocks): the rows spread over one cluster of
    MAX_CLUSTER blocks (fewer where there are fewer rows), ceil(B /
    MAX_CLUSTER) a block, 2 at the learner's B 32: a block of 32 warps
    issues ~5x slower than the parent's 32 blocks of one sequence (measured).
    Raises where a block would take more than MAX_SEQS sequences or its
    shared memory (each sequence's, and block 0's four partials a row) would
    not fit (past 288 sequences at T 80, A 18)."""
    if rows < 1 or actions < 1 or not 1 <= steps <= MAX_STEPS:
        raise ValueError(f"K11 takes B, A >= 1 and 1 <= T <= {MAX_STEPS}, got {rows}, {actions}, "
                         f"{steps}")
    per_block = -(-rows // MAX_CLUSTER)
    if per_block > MAX_SEQS or per_block * seq_bytes(steps, actions) + 16 * rows > SMEM_LIMIT:
        raise ValueError(f"K11 runs at most {MAX_CLUSTER} blocks of {MAX_SEQS} sequences whose "
                         f"q_sel and q_tgt rows fit {SMEM_LIMIT} bytes of shared memory; "
                         f"B {rows}, T {steps}, A {actions} do not")
    return per_block, -(-rows // per_block)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_r2d2_td
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 7 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_writeback(wb: Writeback, batch: int, device: torch.device) -> int:
    """The groups of a fold's write-back target, or a raise."""
    if wb.idx.dim() != 2 or wb.idx.numel() != batch:
        raise ValueError(f"K6s in K11 takes idx [G, B / G] over the batch of {batch}, got "
                         f"{tuple(wb.idx.shape)}")
    if (wb.priority.dtype, wb.max_priority.dtype, wb.idx.dtype) != (
            torch.float32, torch.float32, torch.int32):
        raise TypeError("K6s in K11 takes fp32 priorities and max_priority, int32 idx")
    if wb.priority.dim() != 1 or wb.max_priority.dim() != 0:
        raise ValueError("K6s in K11 takes priority [C] and max_priority []")
    for t in wb[:3]:
        if t.device != device or not t.is_contiguous():
            raise ValueError("K6s in K11: the ring and ids must be contiguous on the loss's "
                             "device")
    return wb.idx.shape[0]


def r2d2_td(q_taken, q_sel, q_tgt, reward, done, valid, weight, p: TDParams,
            writeback: Optional[Writeback] = None):
    """K11 on ``q_taken.device``: the kernel on CUDA, the plain twin on the
    CPU.  ``writeback``: K6s's write-back of the priorities into the
    sequence ring, in the same launch on CUDA (after the twin on the CPU)."""
    if q_taken.device.type == "cpu":
        out = r2d2_td_plain(q_taken, q_sel, q_tgt, reward, done, valid, weight, p)
        if writeback is not None:
            seq_writeback_plain(writeback.priority, writeback.max_priority, writeback.idx,
                                out[1], writeback.eps, writeback.omega)
        return out
    batch, steps = q_taken.shape
    actions = q_sel.shape[-1]
    want = {"q_taken": ((batch, steps), torch.float32),
            "q_sel": ((batch, steps, actions), torch.float32),
            "q_tgt": ((batch, steps, actions), torch.float32),
            "reward": ((batch, steps), torch.float32), "done": ((batch, steps), torch.bool),
            "valid": ((batch, steps), torch.bool), "weight": ((batch,), torch.float32)}
    given = dict(q_taken=q_taken, q_sel=q_sel, q_tgt=q_tgt, reward=reward, done=done,
                 valid=valid, weight=weight)
    for name, t in given.items():
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"K11: {name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != q_taken.device:
            raise ValueError("K11 inputs must be on one device")
        if name in ("reward", "done", "valid"):  # column slices of the batch's rows
            if t.stride(-1) != 1 and steps > 1:
                raise ValueError(f"K11 reads {name} with a unit column stride")
        elif not t.is_contiguous():
            raise ValueError(f"K11 reads {name} contiguous")
    if not 1 <= p.n < steps:
        raise ValueError(f"K11: n = {p.n} must be in [1, {steps})")
    per_block, _ = td_plan(batch, steps, actions)
    dev = q_taken.device
    groups = 0 if writeback is None else _check_writeback(writeback, batch, dev)
    wb = writeback or Writeback(None, None, None, 0.0, 0.0)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    q_mean = torch.empty((), dtype=torch.float32, device=dev)
    priorities = torch.empty((batch,), dtype=torch.float32, device=dev)
    dq = torch.empty((batch, steps), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _entry()(
            *(build.ptr(t) for t in (q_taken, q_sel, q_tgt, reward, done, valid)),
            reward.stride(0), done.stride(0), valid.stride(0), build.ptr(weight),
            build.ptr(loss), build.ptr(priorities), build.ptr(q_mean), build.ptr(dq), batch,
            steps, actions, p.n, per_block, p.gamma, p.gamma ** p.n, p.eta, 1.0 - p.eta, p.eps,
            4.0 * p.eps, 2.0 * p.eps, build.ptr(wb.priority), build.ptr(wb.max_priority),
            build.ptr(wb.idx), 0 if writeback is None else wb.priority.numel(), groups,
            float(wb.eps), float(wb.omega), build.stream_of(dev))
    build.check_launch(NAME, code, fold=None if writeback is None else K6S_NAME)
    return loss, priorities, q_mean, dq


class R2D2TDFn(torch.autograd.Function):
    """K11 forward; backward = its d loss / d q_taken times the incoming
    gradient.  (q_taken, q_sel, q_tgt, reward, done, valid, weight, params,
    writeback) -> (loss, priorities, q_mean); only loss is differentiable,
    in q_taken.  ``writeback``: a ``Writeback`` target or None."""

    @staticmethod
    def forward(ctx, q_taken, q_sel, q_tgt, reward, done, valid, weight, params, writeback=None):
        loss, priorities, q_mean, dq = r2d2_td(q_taken, q_sel, q_tgt, reward, done, valid,
                                               weight, params, writeback)
        ctx.save_for_backward(dq)
        ctx.mark_non_differentiable(priorities, q_mean)
        return loss, priorities, q_mean

    @staticmethod
    def backward(ctx, dloss, dpriorities, dq_mean):
        (dq,) = ctx.saved_tensors
        return dq * dloss, None, None, None, None, None, None, None, None
