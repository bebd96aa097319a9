"""K6f: the device sample frontier's fenced write-back into the mirror, from
its queue of mirror updates.

Replaces ``DeviceSampleFrontier``'s ``_writeback``
(``rainbow_iqn_apex_tpu/replay/frontier.py:145-153``, dispatched by :271-286)
and its staged scatter (:305-327), in place, one segment of a
``MirrorQueue`` after another:

    staged       mirror[idx] = value                               distinct slots
    write-back   pri         = (|td| + eps)^omega                  f32 [B]
                 mirror[idx] = where(mirror[idx] > 0, pri, 0)      never resurrect a slot

No max priority is kept (K6 keeps one; the frontier leaves the fresh-item
default to the host trees).  Each write-back's fence reads the mirror as the
segments before it left it; a repeated id is written with its last
occurrence's value (JAX leaves their order open, frontier.py:275-277).
omega = 0.5 takes a square root.  The kernel drops an id outside [0, N);
the twin raises on one.

The frontier (``replay/frontier.py``) queues its staged appends and learner
write-backs in program order and hands the queue to its next draw: K5f's
first launch applies it (``frontier_draw(..., queue=)``, the fold).  This
module's launch applies it where the mirror is read or changed outside a
draw.  Applying a write-back batch entry by entry would differ from the
batch's fence where a repeated id's earlier occurrence is NaN (NaN > 0 is
false), so the kernels keep each batch's fence.

Bound on the H100: a few hundred bytes a batch of 32, launch-bound.  The
kernel (``csrc/frontier_writeback.cu``) is one block that walks the
segments in order, a barrier between each batch's fence reads and its
writes.

``frontier_apply`` runs the kernel for CUDA tensors and
``frontier_apply_plain`` for CPU tensors; ``frontier_writeback`` applies one
batch (a queue of one).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from rainbow_iqn_apex_tpu_torch.kernels import build
from rainbow_iqn_apex_tpu_torch.kernels.replay_writeback import priority_power

NAME = "K6f_frontier_writeback"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/frontier_writeback.cu"
REPLACES = "rainbow_iqn_apex_tpu/replay/frontier.py:145"
STAGED, WRITEBACK = 0, 1  # segment kinds (csrc/writeback.cuh: kStaged, kWriteback)
QUEUE_SEGMENTS = 32  # a queue's segments (csrc: kQueueSegments)
MAX_BATCH = 1024  # rows of a write-back batch (csrc: kSegmentRows x 256 threads)


class _Segment(ctypes.Structure):
    _fields_ = [("ids", ctypes.c_void_p), ("vals", ctypes.c_void_p), ("n", ctypes.c_int),
                ("kind", ctypes.c_int)]


class _Queue(ctypes.Structure):  # csrc/writeback.cuh: MirrorQueue
    _fields_ = [("seg", _Segment * QUEUE_SEGMENTS), ("segments", ctypes.c_int),
                ("longest", ctypes.c_int), ("eps", ctypes.c_float), ("omega", ctypes.c_float)]


class MirrorQueue:
    """Mirror updates in program order, not yet applied: staged segments
    (leaf values at distinct slots) and write-back batches (ids and the
    learner's |TD|).  It holds the tensors it is given until it is applied;
    their writers must not write into them before that."""

    def __init__(self, eps: float, omega: float):
        self.eps = float(eps)
        self.omega = float(omega)
        self.segments: List[Tuple[int, torch.Tensor, torch.Tensor]] = []

    def __len__(self) -> int:
        return len(self.segments)

    @property
    def full(self) -> bool:
        return len(self.segments) >= QUEUE_SEGMENTS

    def _add(self, kind: int, ids: torch.Tensor, vals: torch.Tensor) -> None:
        if self.full:
            raise RuntimeError(f"the mirror queue holds {QUEUE_SEGMENTS} segments: apply it first")
        if ids.dtype != torch.int32 or vals.dtype != torch.float32:
            raise TypeError("K6f takes int32 ids and fp32 values")
        if ids.dim() != 1 or vals.shape != ids.shape:
            raise ValueError(f"K6f takes ids [B] and values [B], got {tuple(ids.shape)} and "
                             f"{tuple(vals.shape)}")
        if kind == WRITEBACK and not 1 <= ids.shape[0] <= MAX_BATCH:
            raise ValueError(f"K6f takes 1 <= B <= {MAX_BATCH} rows a write-back, "
                             f"got B {ids.shape[0]}")
        if not (ids.is_contiguous() and vals.is_contiguous()) or ids.device != vals.device:
            raise ValueError("K6f inputs must be contiguous on one device")
        self.segments.append((kind, ids, vals))

    def stage(self, ids: torch.Tensor, values: torch.Tensor) -> None:
        """Plain sets of leaf values at distinct slots."""
        self._add(STAGED, ids, values)

    def writeback(self, ids: torch.Tensor, td: torch.Tensor) -> None:
        """One learn step's fenced write-back of |td|."""
        self._add(WRITEBACK, ids, td)

    def clear(self) -> None:
        self.segments = []

    def struct(self, device: torch.device) -> _Queue:
        """The queue as the kernels take it (by value)."""
        q = _Queue()
        for s, (kind, ids, vals) in enumerate(self.segments):
            if ids.device != device:
                raise ValueError(f"K6f: a queued segment lies on {ids.device}, the mirror on "
                                 f"{device}")
            q.seg[s] = _Segment(ids.data_ptr(), vals.data_ptr(), ids.shape[0], kind)
        q.segments, q.eps, q.omega = len(self.segments), self.eps, self.omega
        q.longest = max((ids.shape[0] for _, ids, _ in self.segments), default=0)
        return q


def frontier_writeback_plain(mirror: torch.Tensor, idx: torch.Tensor, td: torch.Tensor,
                             eps: float, omega: float) -> None:
    """One write-back batch: mirror [N] f32 in place; idx [B] int32, td [B] f32."""
    ids = idx.long()
    pri = priority_power(td.to(torch.float32).abs() + eps, omega)
    value = torch.where(mirror[ids] > 0, pri, torch.zeros_like(pri))
    order = torch.arange(ids.shape[0], device=ids.device)
    # every occurrence of an id writes its last occurrence's value, so the
    # scatter's order among duplicates does not matter
    last = torch.where(ids[:, None] == ids[None, :], order, -1).amax(dim=1)
    mirror.index_put_((ids,), value[last])


def frontier_apply_plain(mirror: torch.Tensor, queue: MirrorQueue) -> None:
    """Every segment of ``queue`` into mirror [N] f32, in order."""
    for kind, ids, vals in queue.segments:
        if kind == STAGED:
            mirror.index_copy_(0, ids.long(), vals)
        else:
            frontier_writeback_plain(mirror, ids, vals, queue.eps, queue.omega)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_frontier_writeback
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def frontier_apply(mirror: torch.Tensor, queue: MirrorQueue) -> None:
    """K6f on ``mirror.device``: the kernel on CUDA (one launch, none for an
    empty queue), the plain twin on the CPU.  Leaves the queue as it was."""
    if mirror.device.type == "cpu":
        return frontier_apply_plain(mirror, queue)
    if not len(queue):
        return None
    if mirror.dtype != torch.float32 or mirror.dim() != 1 or not mirror.is_contiguous():
        raise ValueError("K6f takes a contiguous fp32 mirror [N]")
    q = queue.struct(mirror.device)
    with torch.cuda.device(mirror.device):
        code = _entry()(build.ptr(mirror), mirror.numel(), ctypes.byref(q),
                        build.stream_of(mirror.device))
    build.check_launch(NAME, code)


def frontier_writeback(mirror: torch.Tensor, idx: torch.Tensor, td: torch.Tensor,
                       eps: float, omega: float) -> None:
    """One write-back batch (idx [B] int32, td [B] f32) into mirror [N] f32:
    K6f on CUDA, the plain twin on the CPU."""
    if mirror.device.type == "cpu":
        return frontier_writeback_plain(mirror, idx, td, eps, omega)
    queue = MirrorQueue(eps, omega)
    queue.writeback(idx, td)
    frontier_apply(mirror, queue)
