"""K9 / K9-bwd: the resettable fp32 LSTM recurrence of R2D2 and its backward.

Replaces ``rainbow_iqn_apex_tpu/models/r2d2.py:_ResettableLSTMStep``
(:39-47), scanned by ``R2D2Net.__call__`` (:89-96), and the backward
``jax.grad`` makes of that scan.  Per step t (flax ``OptimizedLSTMCell``,
gates i, f, g, o in the columns g*H + j of the [H, 4H] recurrent kernel)::

    c, h = c * (1 - reset[:, t]), h * (1 - reset[:, t])
    pre  = (h @ w_h + b) + xw[:, t]
    c    = sigmoid(pre_f) * c + sigmoid(pre_i) * tanh(pre_g)
    h    = sigmoid(pre_o) * tanh(c)

``xw = phi @ W_i`` for all steps is one plain matrix product outside the
kernel (the caller's), as are the backward's dW_h, db, dW_i and dphi; the
kernels (``csrc/lstm.cu``) own the recurrence, one launch per unroll.  The
batch is cut into groups of at most 8 rows, each run by one thread-block
cluster whose blocks pass h (or the backward's partial sums of dh) to each
other through distributed shared memory; ``forward_plan`` /
``backward_plan`` pick the groups from the card's cluster occupancy, and
the act tick (T = 1) is a plain grid.  The kernels take lstm sizes up to
512 (a cluster of 16 blocks of 32 units).  Bound: the serial chain of T
steps; see the source.

``lstm_forward`` runs the kernel for CUDA tensors and ``lstm_forward_plain``
for CPU tensors; ``lstm_backward`` / ``lstm_backward_plain`` likewise for the
backward through time, which returns d loss / d pre [B, T, 4H] (= d loss /
d xw).  ``LSTMFn`` is the ``torch.autograd.Function`` over them: no
gradient reaches the initial state (R2D2 stores it and stops its gradient).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K9_lstm"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/lstm.cu"
REPLACES = "rainbow_iqn_apex_tpu/models/r2d2.py:39"
NAME_BWD = NAME + "_bwd"
SOURCE_BWD = SOURCE
REPLACES_BWD = "rainbow_iqn_apex_tpu/ops/r2d2.py:136"

UNITS = 32  # hidden units of a cluster block (csrc/lstm.cu kUnits)
MAX_BLOCKS = 16  # blocks of a cluster: K9 takes lstm sizes up to 16 x 32
MAX_ROWS = 8  # batch rows of a cluster (csrc/lstm.cu kMaxRows)
TICK_UNITS = 4  # T = 1: hidden units of a grid block
TICK_THREADS = 256
THREADS = 256
SHARED_LIMIT = 232448  # opt-in shared bytes of one block (227 KB)
MAX_HIDDEN = UNITS * MAX_BLOCKS
# csrc/lstm.cu's kFwdShared / kBwdShared: a cluster block's two barriers, its
# W_h half, its h (forward) or partials of dh (backward), split sums, pre or
# dpre, c or dc; the backward's cell inputs and outgoing partials
FWD_SHARED = 16 + 4 * (8 * 32 * 128 + 2 * MAX_ROWS * 512 + 8 * MAX_ROWS * 128 + MAX_ROWS * 128
                  + MAX_ROWS * 32)
BWD_SHARED = 16 + 4 * (512 * (128 - 64) + 2 * MAX_BLOCKS * MAX_ROWS * 32 + MAX_ROWS * 128
                       + MAX_ROWS * 32 + MAX_ROWS * 32 * 8 + MAX_ROWS * 512)


def _tick_shared(rows: int) -> int:
    """csrc/lstm.cu's tick_shared: h [R, 512], split sums [32, 4, 16], pre [R, 16]."""
    return 4 * (rows * 512 + 32 * 4 * 16 + rows * 16)


class LaunchPlan(NamedTuple):
    units: int  # hidden units of a block
    threads: int
    unit_blocks: int  # blocks of a group: a cluster's size (T > 1), grid.x (T = 1)
    groups: int  # G: batch groups, each its own recurrence
    rows: int  # R: batch rows of a group (the last may hold fewer)
    shared: int  # dynamic shared bytes of a block
    cluster: bool  # T > 1: a group's blocks form a cluster and exchange through DSMEM


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_shape(batch: int, steps: int, hidden: int) -> None:
    if batch < 1 or steps < 1:
        raise ValueError(f"K9 needs B, T >= 1, got {batch}, {steps}")
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"K9 takes lstm sizes up to {MAX_HIDDEN}, got {hidden}")


def _cluster_plan(batch: int, hidden: int, clusters: int) -> LaunchPlan:
    """Groups of at most MAX_ROWS rows, one cluster each: as many as the
    card runs at once (``clusters``), unless that leaves more than MAX_ROWS
    rows a group; then as few rows a group as that count allows.  More
    groups than the card holds at once run in turn: no cluster waits on
    another."""
    size = _cdiv(hidden, UNITS)
    if clusters < 1:
        raise RuntimeError(f"K9: the card runs no cluster of {size} blocks")
    rows = min(MAX_ROWS, _cdiv(batch, min(batch, clusters)))
    return LaunchPlan(UNITS, THREADS, size, _cdiv(batch, rows), rows, 0, True)


@functools.lru_cache(maxsize=256)
def forward_plan(batch: int, steps: int, hidden: int, clusters: int) -> LaunchPlan:
    """K9's launch for [batch, steps, hidden] on a card that runs
    ``clusters`` clusters of its blocks at once (T > 1); T = 1 is one grid
    of hidden / 4 blocks over the whole batch."""
    _check_shape(batch, steps, hidden)
    if steps > 1:
        return _cluster_plan(batch, hidden, clusters)._replace(shared=FWD_SHARED)
    groups = 1
    while _tick_shared(_cdiv(batch, groups)) > SHARED_LIMIT:
        groups += 1
    rows = _cdiv(batch, groups)
    return LaunchPlan(TICK_UNITS, TICK_THREADS, _cdiv(hidden, TICK_UNITS), _cdiv(batch, rows),
                      rows, _tick_shared(rows), False)


@functools.lru_cache(maxsize=256)
def backward_plan(batch: int, steps: int, hidden: int, clusters: int) -> LaunchPlan:
    """K9-bwd's launch for [batch, steps, hidden] on a card that runs
    ``clusters`` clusters of its blocks at once."""
    _check_shape(batch, steps, hidden)
    return _cluster_plan(batch, hidden, clusters)._replace(shared=BWD_SHARED)


@functools.lru_cache(maxsize=None)
def max_clusters(index: int, hidden: int, backward: bool) -> int:
    """How many clusters of K9's (K9-bwd's) blocks for ``hidden`` units the
    card ``index`` runs at once (the occupancy query; 0 where it cannot
    say)."""
    fn = build.library().port_lstm_max_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    with torch.cuda.device(index):
        return int(fn(_cdiv(hidden, UNITS), int(backward)))


def _device(t: torch.Tensor) -> torch.device:
    index = t.device.index
    return torch.device("cuda", torch.cuda.current_device() if index is None else index)


def lstm_forward_plain(xw: torch.Tensor, w_h: torch.Tensor, b: torch.Tensor,
                       reset: torch.Tensor, c0: torch.Tensor, h0: torch.Tensor,
                       save: bool = False):
    """xw [B, T, 4H], w_h [H, 4H], b [4H] fp32, reset [B, T] bool, c0 / h0
    [B, H] -> (h_seq [B, T, H], c_T, h_T, saved); ``saved`` is (gate
    activations [B, T, 4H], c [B, T, H]) with ``save``, else None."""
    batch, steps, _ = xw.shape
    hidden = w_h.shape[0]
    keep = 1.0 - reset.to(torch.float32)
    c, h = c0, h0
    hs, acts, cs = [], [], []
    for t in range(steps):
        k = keep[:, t:t + 1]
        c, h = c * k, h * k
        pre = (h @ w_h + b) + xw[:, t]
        i, f, g, o = pre.split(hidden, dim=1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        if save:
            acts.append(torch.cat([i, f, g, o], dim=1))
            cs.append(c)
    saved = (torch.stack(acts, 1), torch.stack(cs, 1)) if save else None
    return torch.stack(hs, 1), c, h, saved


def lstm_backward_plain(dh_seq: torch.Tensor, dh_last: Optional[torch.Tensor],
                        dc_last: Optional[torch.Tensor], w_h: torch.Tensor,
                        reset: torch.Tensor, gates: torch.Tensor, c_seq: torch.Tensor,
                        c0: torch.Tensor) -> torch.Tensor:
    """Backward through time of ``lstm_forward_plain`` from the gradients of
    h_seq (and of the final c, h when given) -> d loss / d pre [B, T, 4H]."""
    batch, steps, hidden = dh_seq.shape
    keep = 1.0 - reset.to(torch.float32)
    dpre = torch.empty((batch, steps, 4 * hidden), dtype=torch.float32, device=dh_seq.device)
    dc = dc_last.clone() if dc_last is not None else torch.zeros_like(c0)
    dh_rec = torch.zeros_like(c0)
    for t in range(steps - 1, -1, -1):
        dh = dh_seq[:, t] + dh_rec
        if t == steps - 1 and dh_last is not None:
            dh = dh + dh_last
        i, f, g, o = gates[:, t].split(hidden, dim=1)
        c = c_seq[:, t]
        tc = torch.tanh(c)
        k = keep[:, t:t + 1]
        c_prev = (c0 if t == 0 else c_seq[:, t - 1]) * k
        dc = dc + dh * o * (1.0 - tc * tc)
        d = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                       dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=1)
        dpre[:, t] = d
        dc = dc * f * k
        dh_rec = (d @ w_h.t()) * k
    return dpre


@functools.lru_cache(maxsize=None)
def _fwd_entry():
    fn = build.library().port_lstm_fwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = build.library().port_lstm_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(what: str, dev: torch.device, shapes, tensors) -> None:
    for name, t in tensors.items():
        if t is None:
            continue
        want = shapes[name]
        dtype = torch.bool if name == "reset" else torch.float32
        if t.dtype != dtype or tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} must be {dtype} {want}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous on one device")


def lstm_forward(xw: torch.Tensor, w_h: torch.Tensor, b: torch.Tensor, reset: torch.Tensor,
                 c0: torch.Tensor, h0: torch.Tensor, save: bool = False):
    """K9 on ``xw.device``: the kernel on CUDA, the plain twin on the CPU."""
    if xw.device.type == "cpu":
        return lstm_forward_plain(xw, w_h, b, reset, c0, h0, save)
    batch, steps, _ = xw.shape
    hidden = w_h.shape[0]
    shapes = {"xw": (batch, steps, 4 * hidden), "w_h": (hidden, 4 * hidden),
              "b": (4 * hidden,), "reset": (batch, steps), "c0": (batch, hidden),
              "h0": (batch, hidden)}
    _check("K9", xw.device, shapes, dict(xw=xw, w_h=w_h, b=b, reset=reset, c0=c0, h0=h0))
    dev = _device(xw)
    _check_shape(batch, steps, hidden)
    clusters = max_clusters(dev.index, hidden, False) if steps > 1 else 0
    plan = forward_plan(batch, steps, hidden, clusters)
    h_seq = torch.empty((batch, steps, hidden), dtype=torch.float32, device=dev)
    c_last = torch.empty((batch, hidden), dtype=torch.float32, device=dev)
    h_last = torch.empty((batch, hidden), dtype=torch.float32, device=dev)
    saved = None
    if save:
        saved = (torch.empty((batch, steps, 4 * hidden), dtype=torch.float32, device=dev),
                 torch.empty((batch, steps, hidden), dtype=torch.float32, device=dev))
    with torch.cuda.device(dev):
        code = _fwd_entry()(
            build.ptr(xw), build.ptr(w_h), build.ptr(b), build.ptr(reset), build.ptr(c0),
            build.ptr(h0), build.ptr(h_seq), build.ptr(c_last), build.ptr(h_last),
            build.ptr(saved[0] if save else None), build.ptr(saved[1] if save else None),
            batch, steps, hidden, plan.groups, plan.rows, build.stream_of(dev))
    build.check_launch(NAME, code)
    return h_seq, c_last, h_last, saved


def lstm_backward(dh_seq: torch.Tensor, dh_last: Optional[torch.Tensor],
                  dc_last: Optional[torch.Tensor], w_h: torch.Tensor, reset: torch.Tensor,
                  gates: torch.Tensor, c_seq: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """K9-bwd on ``dh_seq.device``: the kernel on CUDA, the plain twin on the CPU."""
    if dh_seq.device.type == "cpu":
        return lstm_backward_plain(dh_seq, dh_last, dc_last, w_h, reset, gates, c_seq, c0)
    batch, steps, hidden = dh_seq.shape
    shapes = {"dh_seq": (batch, steps, hidden), "dh_last": (batch, hidden),
              "dc_last": (batch, hidden), "w_h": (hidden, 4 * hidden), "reset": (batch, steps),
              "gates": (batch, steps, 4 * hidden), "c_seq": (batch, steps, hidden),
              "c0": (batch, hidden)}
    _check("K9-bwd", dh_seq.device, shapes,
           dict(dh_seq=dh_seq, dh_last=dh_last, dc_last=dc_last, w_h=w_h, reset=reset,
                gates=gates, c_seq=c_seq, c0=c0))
    dev = _device(dh_seq)
    _check_shape(batch, steps, hidden)
    plan = backward_plan(batch, steps, hidden, max_clusters(dev.index, hidden, True))
    dpre = torch.empty((batch, steps, 4 * hidden), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _bwd_entry()(
            build.ptr(dh_seq), build.ptr(dh_last), build.ptr(dc_last), build.ptr(w_h),
            build.ptr(reset), build.ptr(gates), build.ptr(c_seq), build.ptr(c0), build.ptr(dpre),
            batch, steps, hidden, plan.groups, plan.rows, build.stream_of(dev))
    build.check_launch(NAME_BWD, code)
    return dpre


class LSTMFn(torch.autograd.Function):
    """K9 forward, K9-bwd backward: (xw, w_h, b, reset, c0, h0) -> (h_seq,
    c_T, h_T), differentiable in xw, w_h and b.  dW_h and db are plain
    products over the steps: h_{t-1} * keep_t against d pre_t."""

    @staticmethod
    def forward(ctx, xw, w_h, b, reset, c0, h0):
        if c0.requires_grad or h0.requires_grad:
            raise ValueError("K9 gives no gradient to the initial state")
        h_seq, c_last, h_last, (gates, c_seq) = lstm_forward(xw, w_h, b, reset, c0, h0,
                                                             save=True)
        ctx.save_for_backward(w_h, reset, c0, h0, h_seq, gates, c_seq)
        return h_seq, c_last, h_last

    @staticmethod
    def backward(ctx, dh_seq, dc_last, dh_last):
        w_h, reset, c0, h0, h_seq, gates, c_seq = ctx.saved_tensors
        if dh_seq is None:
            dh_seq = torch.zeros_like(h_seq)
        dpre = lstm_backward(dh_seq.contiguous(), None if dh_last is None else dh_last.contiguous(),
                             None if dc_last is None else dc_last.contiguous(), w_h, reset,
                             gates, c_seq, c0)
        keep = (1.0 - reset.to(torch.float32))[..., None]
        h_in = torch.cat([h0[:, None], h_seq[:, :-1]], dim=1) * keep  # [B, T, H]
        flat = dpre.reshape(-1, dpre.shape[-1])
        dw_h = h_in.reshape(-1, h_in.shape[-1]).t() @ flat
        return dpre, dw_h, flat.sum(dim=0), None, None, None
