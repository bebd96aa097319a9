"""Device-resident sample frontier of the port: the Ape-X host replay's
priority vector mirrored into device memory, drawn from by K5f and written
back into by K6f, mostly inside K5f's draw.

Counterpart of ``rainbow_iqn_apex_tpu/replay/frontier.py``:

- ``DeviceSampleFrontier`` mirrors every shard's tree-space priority leaves
  into one device vector ``[num_shards * shard_capacity]`` f32 and draws
  blocks of G stratified index batches with their sample probabilities and
  per-batch max-normalised IS weights (K5f, ``kernels/frontier_draw.py``).
- The learner's priority write-back retires straight into the mirror (K6f,
  ``kernels/frontier_writeback.py``) from the ring's still-on-device |TD|;
  the host sum-trees become the cold path, caught up at ring drains by
  ``reconcile``.
- Host appends keep writing the host trees; each append's leaf deltas are
  staged (``stage``) and flushed as one segment before the next draw or
  write-back, after the host has kept the last write per slot and dropped
  the dead shards' rows.
- ``on_drop`` zeroes a dead shard's slice (draws exclude it, and the
  never-resurrect fence drops any lagged write-back to it), ``on_readmit``
  and ``refresh_from_host`` reload from the host trees under new epochs;
  draw blocks carry the epoch / dead-set stamp they were drawn under.

Differences of form from the JAX module:

- JAX's mirror is immutable: every draw reads a snapshot, and XLA orders the
  scatters by data dependence.  The port updates one tensor in place, so
  every mirror kernel and copy (K5f, K6f, the slice writes, the refresh,
  the read-back) is launched on the frontier's own CUDA stream under its
  lock, in the order the calls are made; a call that takes a tensor from
  the caller's stream (the learner's |TD|) makes the frontier stream wait
  for it first.
- A flush and a write-back launch nothing: each appends a segment to a
  queue of mirror updates (``MirrorQueue``), in program order, and the next
  draw hands the queue to K5f, whose first launch applies it before its sums
  (K6f folded into K5f).  Every other access to the mirror applies the queue
  first with one K6f launch: ``mirror`` (a property), ``mirror_np``,
  ``reconcile``, ``on_drop``, ``on_readmit``, the 4,096-row flush of
  ``stage`` and a full queue (``flushes`` counts them); ``refresh_from_host``
  overwrites the whole mirror and drops the queue.  Whatever reads the
  mirror sees what the parent's launch-per-call frontier left there, bit
  for bit.
- The draw's uniforms come from the frontier's ``torch.Generator`` on the
  device (seeded from ``seed``), or from ``uniforms=`` (the tests hand in
  JAX's).  A draw block copies its ids and weights to pinned host memory
  behind an event, so a worker thread reads them without a device-wide sync.
- A repeated slot in one write-back is written with its last occurrence's
  value (JAX leaves the order open).
- ``make_batch_assembler`` returns the host ``SampledBatch``; the pusher
  (``utils/prefetch.py:SampleAheadPusher``) stages it, ids included.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.kernels.frontier_draw import frontier_draw
from rainbow_iqn_apex_tpu_torch.kernels.frontier_writeback import MirrorQueue, frontier_apply
from rainbow_iqn_apex_tpu_torch.ops.act import DeviceLike, resolve_device
from rainbow_iqn_apex_tpu_torch.utils import hostsync


class DrawBlock:
    """One dispatched draw: ``G`` stratified index batches on the device,
    their pinned host copies (``host()``), and the epoch / dead-set stamp the
    mirror had when it was drawn."""

    __slots__ = ("idx", "weight", "prob", "stamp", "group_size", "groups", "_host", "_event",
                 "_arrays")

    def __init__(self, idx: torch.Tensor, weight: torch.Tensor, prob: torch.Tensor, stamp,
                 group_size: int, groups: int):
        self.idx = idx  # [G, B] int32 global slot ids (device)
        self.weight = weight  # [G, B] f32 per-batch max-normalised IS weights (device)
        self.prob = prob  # [G, B] f32 global sample probabilities (device)
        self.stamp = stamp  # (epochs tuple, dead frozenset) at draw time
        self.group_size = group_size
        self.groups = groups
        self._event = None
        self._arrays = None
        if idx.device.type == "cuda":  # on the current (the frontier's) stream
            self._host = (torch.empty(idx.shape, dtype=idx.dtype, pin_memory=True),
                          torch.empty(weight.shape, dtype=weight.dtype, pin_memory=True))
            self._host[0].copy_(idx, non_blocking=True)
            self._host[1].copy_(weight, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = (idx, weight)

    def host(self) -> Tuple[np.ndarray, np.ndarray]:
        """(idx [G, B] int64, weight [G, B] f32) on the host.  Waits for the
        copies' event (once), not for the device: safe on a worker thread
        while another thread forbids host syncs."""
        if self._arrays is None:
            if self._event is not None:
                self._event.synchronize()
            idx, weight = self._host
            self._arrays = (idx.numpy().astype(np.int64), weight.numpy().copy())
        return self._arrays


class DeviceSampleFrontier:
    """Device priority mirror + K5f draw + K6f in-mirror write-back, over a
    list of host ``SumTree``s (one per replay shard, all of capacity
    ``shard_capacity``); ``from_sharded`` wires a ``ShardedReplay``.  Every
    mirror mutation is serialized by one lock and issued on one stream:
    the critical sections only enqueue work and never wait for the device.
    Flushes and write-backs are queued for the next draw (module notes)."""

    def __init__(
        self,
        trees: Sequence,  # SumTree per shard (host truth, cold path)
        shard_capacity: int,
        eps: float,
        omega: float,
        registry=None,
        role: str = "frontier",
        seed: int = 0,
        draw_block: int = 8,
        reseed_max_priority: Optional[Callable[[int, float], None]] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.trees = list(trees)
        self.cap = int(shard_capacity)
        self.size = len(self.trees) * self.cap
        if self.size >= np.iinfo(np.int32).max:
            raise ValueError("mirror too large for int32 slot ids")
        self.eps = float(eps)
        self.omega = float(omega)
        self.draw_block = max(int(draw_block), 1)
        self._reseed = reseed_max_priority
        self._lock = threading.Lock()
        self._pending: List[Tuple[np.ndarray, np.ndarray]] = []
        self._pending_rows = 0
        self._epochs = [0] * len(self.trees)
        self._dead: set = set()
        self._all_local = np.arange(self.cap, dtype=np.int64)
        self._queue = MirrorQueue(self.eps, self.omega)
        self.reconciles = 0
        self.flushes = 0  # K6f launches: the queue applied outside a draw
        self._g_reconcile = None
        if registry is not None:
            self._g_reconcile = registry.gauge("mirror_reconcile_s", role)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        with self._on_stream():
            self._mirror = self._upload(self._host_leaves())

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_sharded(cls, memory, registry=None, seed: int = 0, draw_block: int = 8,
                     device: DeviceLike = None) -> "DeviceSampleFrontier":
        """Frontier over a ``parallel.sharded_replay.ShardedReplay``: one
        mirror slice per shard, attached so appends stage deltas and
        drop/readmit fence the mirror (``memory.attach_frontier``)."""
        s0 = memory.shards[0]

        def reseed(k: int, _leaf_max: float) -> None:
            # fresh-item default priority: max over WRITTEN leaves only (the
            # clamped max_leaf: never-written residue must not inflate it)
            shard = memory.shards[k]
            shard.max_priority = max(
                shard.max_priority,
                shard.tree.max_leaf(shard.filled, shard.lanes),
            )

        frontier = cls(
            [s.tree for s in memory.shards],
            memory.shard_capacity,
            eps=s0.eps,
            omega=s0.omega,
            registry=registry,
            seed=seed,
            draw_block=draw_block,
            reseed_max_priority=reseed,
            device=device,
        )
        for k in memory.dead_shards:  # mirror starts fenced like the host
            frontier.on_drop(k)
        memory.attach_frontier(frontier)
        return frontier

    @classmethod
    def from_sequence(cls, memory, registry=None, seed: int = 0, draw_block: int = 8,
                      device: DeviceLike = None) -> "DeviceSampleFrontier":
        raise NotImplementedError(
            "the sequence-replay frontier serves the R2D2 apex loop (K9), not ported yet")

    # ---------------------------------------------------------------- helpers
    @property
    def mirror(self) -> torch.Tensor:
        """The mirror tensor [N] f32, with every queued update applied."""
        with self._lock:
            self._apply_queue()
            return self._mirror

    @property
    def queued(self) -> bool:
        """Whether mirror updates wait (staged rows or queued segments): the
        next access outside a draw launches K6f."""
        return bool(self._pending) or len(self._queue) > 0

    def _apply_queue(self) -> None:
        """The queue into the mirror, one K6f launch (the lock held)."""
        if not len(self._queue):
            return
        with self._on_stream():
            frontier_apply(self._mirror, self._queue)
        self._queue.clear()
        self.flushes += 1

    def _on_stream(self):
        return contextlib.nullcontext() if self.stream is None else torch.cuda.stream(self.stream)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the device, through pinned memory without
        blocking (on the CPU, a copy)."""
        t = torch.from_numpy(np.array(array, copy=True))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _as_device(self, x, dtype: torch.dtype) -> torch.Tensor:
        """``x`` (a tensor or host array) as a flat ``dtype`` tensor on the
        device; a host array goes through pinned memory without blocking."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))
            if self.device.type == "cuda":
                x = x.pin_memory()
        return x.to(self.device, dtype, non_blocking=True).reshape(-1).contiguous()

    def _after_caller(self, *tensors: torch.Tensor) -> None:
        """Order the frontier stream after the caller's, which produced
        ``tensors``, and keep their memory until the frontier used them."""
        if self.stream is None:
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        for t in tensors:
            t.record_stream(self.stream)

    def _host_leaves(self) -> np.ndarray:
        """Current host-tree leaves as one f32 vector (dead shards zeroed:
        the host tree keeps their mass for readmission, the mirror must not
        sample it)."""
        out = np.empty(self.size, np.float32)
        for k, tree in enumerate(self.trees):
            sl = out[k * self.cap:(k + 1) * self.cap]
            if k in self._dead:
                sl[:] = 0.0
            else:
                sl[:] = tree.tree[tree.span:tree.span + self.cap]
        return out

    @property
    def stamp(self) -> Tuple[tuple, frozenset]:
        return (tuple(self._epochs), frozenset(self._dead))

    def stale_rows(self, idx: np.ndarray, stamp) -> int:
        """How many of ``idx`` point into shards whose epoch flipped (drop
        or readmit) since ``stamp`` was taken: the rows a sample-ahead batch
        served past a fence event."""
        epochs, dead = stamp
        changed = [
            k for k in range(len(self.trees))
            if self._epochs[k] != epochs[k] or (k in self._dead) != (k in dead)
        ]
        if not changed:
            return 0
        shard_of = np.asarray(idx).ravel() // self.cap
        return int(np.isin(shard_of, changed).sum())

    # ------------------------------------------------------------------ draw
    def draw(self, batch_size: int, beta: float, n_items: int, groups: Optional[int] = None,
             uniforms=None) -> DrawBlock:
        """Launch one K5f draw of ``groups`` (default ``draw_block``)
        stratified index batches; nothing waits for the device.  Staged
        append deltas flush first.  ``uniforms`` [G, B] in [0, 1) replaces
        the generator's draw."""
        G = self.draw_block if groups is None else max(int(groups), 1)
        B = int(batch_size)
        self.flush_staged()
        with self._lock:
            u = None
            if uniforms is not None:
                u = self._as_device(uniforms, torch.float32).reshape(G, B)
                self._after_caller(u)
            with self._on_stream():
                if u is None:
                    u = torch.rand((G, B), generator=self.generator, device=self.device)
                # K5f applies the queued updates before its sums (K6f folded in)
                idx, prob, weight = frontier_draw(self._mirror, u, beta, max(n_items, 1),
                                                  self._queue)
                self._queue.clear()
                return DrawBlock(idx, weight, prob, self.stamp, B, G)

    # ------------------------------------------------------------- write-back
    def update(self, idx, td_abs) -> None:
        """The learner's priority write-back into the mirror (K6f; the
        ``RingCommitter`` update target when device sampling is on), queued
        for the next draw.  ``idx`` and ``td_abs`` may be device tensors on
        the caller's stream (the staged batch ids, the ring's |TD|) or host
        arrays; the queue holds them until it is applied.  Staged append
        deltas flush first, so the mirror sees them in program order
        (otherwise a slot the cursor just made eligible would drop this
        write-back on the never-resurrect fence while the host tree kept
        it)."""
        self.flush_staged()
        ids = self._as_device(idx, torch.int32)
        td = self._as_device(td_abs, torch.float32)
        if not ids.numel():
            return
        with self._lock:
            self._after_caller(ids, td)
            self._queue.writeback(ids, td)
            if self._queue.full:
                self._apply_queue()

    # ------------------------------------------------------- append mirroring
    def stage(self, global_idx: np.ndarray, values: np.ndarray) -> None:
        """Queue host-append leaf deltas (tree-space values at global slot
        ids) for the next flush; past 4,096 rows, flush and apply now."""
        with self._lock:
            self._pending.append((
                np.asarray(global_idx, np.int64).ravel(),
                np.asarray(values, np.float32).ravel(),
            ))
            self._pending_rows += len(self._pending[-1][0])
            flush_now = self._pending_rows >= 4096
        if flush_now:
            self.flush_staged()
            with self._lock:
                self._apply_queue()

    def flush_staged(self) -> None:
        """Queue every staged append delta as one segment (last write per
        slot wins, the host tree's sequential order; dead shards' rows
        dropped), its ids and values uploaded in one pinned buffer."""
        with self._lock:
            if not self._pending:
                return
            pending, self._pending, self._pending_rows = self._pending, [], 0
            idx = np.concatenate([i for i, _ in pending])
            vals = np.concatenate([v for _, v in pending])
            if idx.size > 1:  # keep the LAST write per duplicate slot
                _, last_pos = np.unique(idx[::-1], return_index=True)
                keep = idx.size - 1 - last_pos
                idx, vals = idx[keep], vals[keep]
            # dead shards stay fenced: their staged rows (an append racing
            # the drop) must not repopulate the zeroed slice
            if self._dead:
                alive = ~np.isin(idx // self.cap, sorted(self._dead))
                idx, vals = idx[alive], vals[alive]
            if idx.size:
                with self._on_stream():
                    both = self._upload(np.concatenate([idx.astype(np.int32),
                                                        vals.astype(np.float32).view(np.int32)]))
                self._queue.stage(both[:idx.size], both[idx.size:].view(torch.float32))
                if self._queue.full:
                    self._apply_queue()

    # -------------------------------------------------------------- elasticity
    def on_drop(self, k: int) -> None:
        """Shard ``k`` died: zero its mirror slice so draws exclude it and
        lagged write-backs to it can never resurrect it."""
        with self._lock:
            self._dead.add(k)
            self._epochs[k] += 1
            self._apply_queue()
            with self._on_stream():
                self._mirror[k * self.cap:(k + 1) * self.cap].zero_()

    def on_readmit(self, k: int) -> None:
        """Shard ``k`` rejoined under a new lease epoch: refresh its slice
        from the host tree (the cold-path truth the rejoining host restored
        or re-seeded)."""
        tree = self.trees[k]
        vals = np.asarray(tree.tree[tree.span:tree.span + self.cap], np.float32)
        with self._lock:
            self._dead.discard(k)
            self._epochs[k] += 1
            self._apply_queue()
            with self._on_stream():
                self._mirror[k * self.cap:(k + 1) * self.cap].copy_(self._upload(vals))

    def refresh_from_host(self, dead=None) -> None:
        """Reload the whole mirror from the host trees (snapshot restore),
        optionally adopting the owner's restored dead-shard set.  Bumps every
        shard's epoch so in-flight draw blocks read as stale.  The queued
        updates are dropped: the whole mirror is overwritten."""
        with self._lock:
            if dead is not None:
                self._dead = set(dead)
            self._pending, self._pending_rows = [], 0
            self._queue.clear()
            self._epochs = [e + 1 for e in self._epochs]
            with self._on_stream():
                self._mirror.copy_(self._upload(self._host_leaves()))

    # --------------------------------------------------------------- reconcile
    def _read_mirror(self) -> np.ndarray:
        with self._lock, hostsync.sanctioned():
            self._apply_queue()
            with self._on_stream():
                return self._mirror.cpu().numpy().copy()

    def reconcile(self) -> float:
        """Drain-boundary sync of the cold path: read the mirror back (a
        sanctioned sync; drains are sync points already) and write it into
        the host sum-trees, so snapshots, readmission re-seeds and a later
        host-sampling run see the learner's priorities.  Returns (and
        gauges) the wall seconds."""
        t0 = time.perf_counter()
        self.flush_staged()
        host = np.maximum(self._read_mirror(), 0.0).astype(np.float64)
        for k, tree in enumerate(self.trees):
            if k in self._dead:
                continue  # the host tree keeps the dead shard's cold truth
            sl = host[k * self.cap:(k + 1) * self.cap]
            tree.set(self._all_local, sl)
            if self._reseed is not None and sl.size:
                self._reseed(k, float(sl.max()))
        dt = time.perf_counter() - t0
        self.reconciles += 1
        if self._g_reconcile is not None:
            self._g_reconcile.set(dt)
        return dt

    def mirror_np(self) -> np.ndarray:
        """The mirror on the host (tests and cold paths only)."""
        return self._read_mirror()


def make_batch_assembler(memory, registry=None, role: str = "prefetch"):
    """The pusher's host half for a ShardedReplay: global idx + IS weights
    -> host ``SampledBatch`` (an index-driven frame gather), rows slot-sorted
    (their write-back ids travel with them as ``sample.idx``).

    Gather-time cursor fence: the ids were drawn against an earlier mirror,
    and by gather time the ring cursor may have moved into a drawn slot's
    history or n-step window.  The append path keeps every such slot's host
    leaf at zero, so ``eligible_mask`` finds those rows exactly; their IS
    weight is zeroed (they add nothing to the loss, and the never-resurrect
    fence drops their write-back) and they count into
    ``sample_ahead_stale_indices_total``."""
    c_stale = None
    if registry is not None:
        c_stale = registry.counter("sample_ahead_stale_indices_total", role)

    def assemble(idx: np.ndarray, weight: np.ndarray):
        ok = memory.eligible_mask(idx)
        if not ok.all():
            if c_stale is not None:
                c_stale.inc(int((~ok).sum()))
            weight = np.where(ok, weight, 0.0).astype(np.float32)
        return memory.assemble_global(idx, weight)

    return assemble
