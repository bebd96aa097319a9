"""ctypes binding for the C++ replay core (replay/native/*.cc).

v1: sum-tree set/find hot loops (sumtree.cc).  v2 adds the fused per-tick
append and per-batch assembly paths (replay_core.cc).  Builds one shared
library on first use with g++ (no pip/pybind11 needed) and caches it in
the port's ``_build/`` directory.  The NumPy implementation is taken only
where no g++ exists (``native_available()`` is the gate): the two draw
different indices, so a build or load that fails with a compiler present
raises with the compiler's stderr rather than switching numerics.

Processes that start together (pytest-xdist workers, the trainer's actor
processes) may all find the library missing: the build runs under an
exclusive ``flock`` on a lock file beside it, g++ writes a temporary name
in the same directory, and ``os.replace`` puts the finished file in place,
so no process ever loads a partial file.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from rainbow_iqn_apex_tpu_torch.replay.sumtree import SumTree

_HERE = os.path.dirname(os.path.abspath(__file__))
# built at first use beside the package, in the directory the CUDA kernels
# build into (listed in .gitignore)
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_SRCS = (
    os.path.join(_HERE, "native", "sumtree.cc"),
    os.path.join(_HERE, "native", "replay_core.cc"),
)


def _so_path() -> str:
    """Cache path keyed by source hash: a stale or foreign-host binary (built
    with -march=native elsewhere) is never loaded — any source change or
    fresh checkout gets its own artifact name and triggers a rebuild."""
    import hashlib

    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, f"_replay_{h.hexdigest()[:16]}.so")


_SO = _so_path()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _build() -> None:
    """Build ``_SO`` unless it exists, under an exclusive lock on a file
    beside it: a process that arrives mid-build waits for the finished
    library.  g++ writes a temporary name that ``os.replace`` moves into
    place, so ``_SO`` is never seen half written."""
    if os.path.exists(_SO):  # name is content-hashed: exists == fresh
        return
    build_dir = os.path.dirname(_SO)
    os.makedirs(build_dir, exist_ok=True)
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_SO):  # another process built it while this one waited
            return
        tmp = f"{_SO}.{os.getpid()}.tmp"
        try:
            done = subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", *_SRCS, "-o", tmp],
                capture_output=True, text=True, timeout=120)
            if done.returncode != 0:
                raise RuntimeError(f"building the native replay core failed:\n{done.stderr}")
            os.replace(tmp, _SO)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _build_and_load() -> Optional[ctypes.CDLL]:
    """The native library, built at first use; None only where no g++
    exists.  A failed build or load raises."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        if shutil.which("g++") is None:
            _tried = True
            return None
        _build()
        lib = ctypes.CDLL(_SO)
        lib.st_set.argtypes = [_f64p, ctypes.c_int64, _i64p, _f64p, ctypes.c_int64]
        lib.st_set.restype = None
        lib.st_find_prefix.argtypes = [
            _f64p, ctypes.c_int64, ctypes.c_int64, _f64p, _i64p, ctypes.c_int64,
        ]
        lib.st_find_prefix.restype = None
        lib.st_sample.argtypes = [
            _f64p, ctypes.c_int64, ctypes.c_int64, _f64p, _i64p, _f64p,
            ctypes.c_int64,
        ]
        lib.st_sample.restype = None
        i64 = ctypes.c_int64
        lib.rb_append_tick.argtypes = [
            _u8p, _i32p, _f32p, _u8p, _u8p,  # frames/actions/rewards/term/cuts
            _f64p, i64,  # tree, span
            i64, i64, i64, i64, i64, i64, i64,  # lanes seg pos filled hist n fb
            _u8p, _i32p, _f32p, _u8p,  # new frame/action/reward/terminal
            ctypes.c_void_p, ctypes.c_void_p,  # truncs?, priorities?
            ctypes.c_double, ctypes.c_double,  # eps, omega
            ctypes.POINTER(ctypes.c_double),  # max_priority (inout)
        ]
        lib.rb_append_tick.restype = None
        lib.rb_assemble.argtypes = [
            _u8p, _i32p, _f32p, _u8p, _u8p,
            i64, i64, i64, i64, i64,  # seg filled hist n fb
            _f32p,  # gammas
            _i64p, i64,  # idx, batch
            _u8p, _u8p, _i32p, _f32p, _f32p,  # outputs
        ]
        lib.rb_assemble.restype = None
        _lib = lib
        _tried = True
        return _lib


def native_available() -> bool:
    return _build_and_load() is not None


class NativeSumTree(SumTree):
    """Drop-in SumTree with the set/find hot loops in C++.

    Same flat-array layout and numerics as the NumPy SumTree (the fuzz test
    runs both against each other); storage stays a NumPy array so snapshots
    and the rest of the Python API are unchanged.
    """

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self._lib = _build_and_load()
        if self._lib is None:
            raise RuntimeError("native sum-tree unavailable (no compiler?)")

    def set(self, idx: np.ndarray, priority: np.ndarray) -> None:
        idx = np.ascontiguousarray(np.asarray(idx, np.int64).ravel())
        pri = np.ascontiguousarray(
            np.broadcast_to(np.asarray(priority, np.float64).ravel(), idx.shape)
        )
        if idx.size == 0:
            return
        if np.any(pri < 0) or not np.all(np.isfinite(pri)):
            raise ValueError("priorities must be finite and non-negative")
        self._lib.st_set(self.tree, self.span, idx, pri, idx.size)

    def find_prefix(self, mass: np.ndarray) -> np.ndarray:
        mass = np.ascontiguousarray(np.asarray(mass, np.float64).ravel())
        out = np.empty(mass.size, np.int64)
        self._lib.st_find_prefix(self.tree, self.span, self.capacity, mass, out, mass.size)
        return out

    def sample_stratified(
        self, batch_size: int, rng: np.random.Generator
    ) -> Tuple[np.ndarray, np.ndarray]:
        total = self.total
        if total <= 0:
            raise ValueError("cannot sample from an empty tree")
        seg = total / batch_size
        mass = np.ascontiguousarray(
            (np.arange(batch_size) + rng.random(batch_size)) * seg
        )
        idx = np.empty(batch_size, np.int64)
        pri = np.empty(batch_size, np.float64)
        self._lib.st_sample(self.tree, self.span, self.capacity, mass, idx, pri, batch_size)
        return idx, pri / total


class ReplayCore:
    """v2 fused append/assemble over a PrioritizedReplay's own arrays.

    One ctypes call per actor tick (ring writes + every tree update,
    including the truncation-eligibility rule) and one per sampled batch
    (n-step scan + both stack gathers straight into the [B, H, W, hist]
    device layout).  The buffer's NumPy arrays are the single source of
    truth; this object holds no state beyond the library handle.
    """

    def __init__(self, buf):
        self._lib = _build_and_load()
        if self._lib is None:
            raise RuntimeError("native replay core unavailable (no compiler?)")
        self._b = buf
        self._fb = buf.frames.shape[1] * buf.frames.shape[2]

    def append_tick(self, frames, actions, rewards, terminals, priorities,
                    truncations) -> float:
        b = self._b
        mp = ctypes.c_double(b.max_priority)
        trunc = (
            None
            if truncations is None
            else np.ascontiguousarray(np.asarray(truncations, bool)).view(np.uint8)
        )
        pri = (
            None
            if priorities is None
            else np.ascontiguousarray(np.asarray(priorities, np.float64))
        )
        self._lib.rb_append_tick(
            b.frames.reshape(b.frames.shape[0], -1),
            b.actions, b.rewards,
            b.terminals.view(np.uint8), b.cuts.view(np.uint8),
            b.tree.tree, b.tree.span,
            b.lanes, b.seg, b.pos, b.filled, b.history, b.n_step, self._fb,
            np.ascontiguousarray(frames, np.uint8).reshape(len(frames), -1),
            np.ascontiguousarray(actions, np.int32),
            np.ascontiguousarray(rewards, np.float32),
            np.ascontiguousarray(np.asarray(terminals, bool)).view(np.uint8),
            None if trunc is None else trunc.ctypes.data_as(ctypes.c_void_p),
            None if pri is None else pri.ctypes.data_as(ctypes.c_void_p),
            b.eps, b.omega, ctypes.byref(mp),
        )
        return mp.value

    def assemble(self, idx: np.ndarray, batch_size: int, out=None):
        """``out`` (obs, next_obs, action, reward, discount), when given,
        receives the rows in place — C-contiguous row slices of a caller's
        batch buffers are accepted, so a shard-sorted gather (the device
        sample frontier's draw returns slot-sorted indices) fills the final
        batch with ZERO extra copies."""
        b = self._b
        h, w = b.frames.shape[1], b.frames.shape[2]
        if out is None:
            obs = np.empty((batch_size, h, w, b.history), np.uint8)
            next_obs = np.empty_like(obs)
            action = np.empty(batch_size, np.int32)
            reward = np.empty(batch_size, np.float32)
            discount = np.empty(batch_size, np.float32)
        else:
            obs, next_obs, action, reward, discount = out
        self._lib.rb_assemble(
            b.frames.reshape(b.frames.shape[0], -1),
            b.actions, b.rewards,
            b.terminals.view(np.uint8), b.cuts.view(np.uint8),
            b.seg, b.filled, b.history, b.n_step, self._fb,
            b._gammas,
            np.ascontiguousarray(idx, np.int64), batch_size,
            obs.reshape(batch_size, -1), next_obs.reshape(batch_size, -1),
            action, reward, discount,
        )
        return obs, next_obs, action, reward, discount
