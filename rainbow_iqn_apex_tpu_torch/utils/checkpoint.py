"""Checkpoint / resume of the port, with ``torch.save``.

Counterpart of ``rainbow_iqn_apex_tpu/utils/checkpoint.py`` (Orbax there).
A checkpoint is one file per step, ``step_<step>.pt`` under the run's
directory, holding the full learner state (``ops.learn.host_state``:
params, target params, the Adam moments and count, the step; of a
``TrainState`` or of R2D2's ``R2D2TrainState``, which has the same fields)
and a JSON-able ``extra`` side-car (frame counter, the generator's state),
so resume is exact for the learner.  Replay snapshots go through the
replay's own ``snapshot`` / ``restore`` (``PrioritizedReplay``,
``SequenceReplay``, ``ShardedReplay``).

Crash safety: the host copy is taken at ``save``; the file is written by one
background thread to a temporary name and renamed into place (atomic on
POSIX), and older steps beyond ``max_to_keep`` are pruned only after the new
one has landed, so at least one whole checkpoint survives any single crash.
``save`` first drains the previous write; ``wait()`` drains it explicitly
and re-raises its error.  A torn or corrupt file is skipped by the
``*_valid`` readers.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from rainbow_iqn_apex_tpu_torch.ops.learn import TrainState, host_state
from rainbow_iqn_apex_tpu_torch.utils import faults, hostsync

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointWriteError(IOError):
    """Injected/observed checkpoint write failure (utils/faults.py)."""


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max(int(max_to_keep), 1)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step):09d}.pt")

    def save(self, step: int, state, extra: Optional[Dict[str, Any]] = None) -> None:
        """Checkpoint ``state`` (a TrainState or R2D2TrainState, or a
        ``host_state`` dict) at
        ``step``.  A step that already exists is kept as it is (a rollback
        can replay the loop over a step that already checkpointed)."""
        self.wait()
        if step in self.all_steps():
            return
        if faults.get().fire("checkpoint_write"):
            raise CheckpointWriteError(f"injected checkpoint write failure at step {step}")
        with hostsync.sanctioned():
            host = host_state(state) if isinstance(state, TrainState) else state
        payload = {"state": host, "extra": dict(extra or {}), "step": int(step)}
        self._thread = threading.Thread(target=self._write, args=(step, payload),
                                        name="checkpoint-writer", daemon=True)
        self._thread.start()

    def _write(self, step: int, payload: Dict[str, Any]) -> None:
        try:
            final = self._path(step)
            tmp = final + ".tmp"
            torch.save(payload, tmp)
            os.replace(tmp, final)
            for old in self.all_steps()[: -self.max_to_keep]:
                os.remove(self._path(old))
        except BaseException as e:  # surfaced by wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def all_steps(self) -> Tuple[int, ...]:
        steps = []
        for name in os.listdir(self.directory):
            m = _NAME.match(name)
            if m:
                steps.append(int(m.group(1)))
        return tuple(sorted(steps))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, step: int) -> Dict[str, Any]:
        return torch.load(self._path(step), map_location="cpu", weights_only=False)

    def restore(self, step: Optional[int] = None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(host state, extra) of ``step`` (default: the latest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        payload = self._load(step)
        return payload["state"], payload["extra"]

    def restore_extra(self, step: Optional[int] = None) -> Dict[str, Any]:
        return self.restore(step)[1]

    def restore_latest_valid(self) -> Optional[Tuple[Dict[str, Any], Dict[str, Any], int]]:
        """(state, extra, step) from the newest step that loads whole,
        scanning past corrupt ones; None when none does."""
        for step in reversed(self.all_steps()):
            try:
                state, extra = self.restore(step)
            except Exception:  # torn or corrupt file: fall back to the previous
                continue
            return state, extra, step
        return None

    def latest_valid_step(self) -> Optional[int]:
        out = self.restore_latest_valid()
        return None if out is None else out[2]

    def close(self) -> None:
        self.wait()


# ---------------------------------------------------------------- replay I/O
def replay_snapshot_path(cfg) -> str:
    """Replay snapshots live next to the checkpoint directory, never in it."""
    return os.path.join(cfg.checkpoint_dir, cfg.run_id + "_replay", "replay")


def save_replay_snapshot(cfg, memory) -> None:
    """Persist replay contents when cfg.snapshot_replay is set."""
    if not cfg.snapshot_replay:
        return
    path = replay_snapshot_path(cfg)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    memory.snapshot(path)


def maybe_restore_replay(cfg, memory) -> bool:
    """Restore a replay snapshot if a usable one exists; returns whether it
    did.  Missing, torn or CRC-failing files degrade to a cold replay."""
    from rainbow_iqn_apex_tpu_torch.replay import snapshot_io

    if not cfg.snapshot_replay:
        return False
    try:
        memory.restore(replay_snapshot_path(cfg))
        return True
    except snapshot_io.MISSING:
        return False


# ------------------------------------------------------------------- resume
def resume_mode(resume) -> str:
    """Normalise Config.resume to ``"off"`` | ``"latest"`` | ``"auto"``:
    ``latest`` restores the newest step and raises if it is corrupt; ``auto``
    restores the newest step that loads, and starts fresh when none exists."""
    if isinstance(resume, bool):
        return "latest" if resume else "off"
    text = str(resume).strip().lower()
    if text in ("", "0", "false", "no", "off", "none"):
        return "off"
    if text == "auto":
        return "auto"
    if text in ("true", "1", "yes", "on", "latest"):
        return "latest"
    raise ValueError(f"unrecognised resume mode {resume!r} (want ''/false, true, or auto)")


def maybe_resume(cfg, ckpt: Checkpointer) -> Optional[Tuple[Dict[str, Any], Dict[str, Any], int]]:
    """(host state, extra, step) when cfg.resume asks for a restart and a
    usable checkpoint exists, else None."""
    mode = resume_mode(cfg.resume)
    if mode == "off":
        return None
    if mode == "auto":
        out = ckpt.restore_latest_valid()
        if out is None and ckpt.all_steps():
            raise RuntimeError(
                f"--resume auto: {len(ckpt.all_steps())} checkpoint step(s) under "
                f"{ckpt.directory} but none loads; refusing to silently start fresh")
        return out
    if ckpt.latest_step() is None:
        return None
    state, extra = ckpt.restore()
    return state, extra, int(ckpt.latest_step())


# ------------------------------------------------------------ RNG side-car
def rng_extra(generator: torch.Generator) -> Dict[str, Any]:
    """The generator's state as checkpoint 'extra' JSON, so resume continues
    the exact tau/noise/action sample stream."""
    return {"rng_state": [int(x) for x in generator.get_state().tolist()]}


def rng_from_extra(extra: Dict[str, Any], fallback: torch.Tensor) -> torch.Tensor:
    """The saved generator state, or ``fallback`` when none was saved."""
    if not extra or "rng_state" not in extra:
        return fallback
    return torch.tensor(extra["rng_state"], dtype=torch.uint8)
