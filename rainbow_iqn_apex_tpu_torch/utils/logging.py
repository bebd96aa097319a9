"""Structured metrics + stdout logging.

Parity: the reference logs episode scores to stdout and plots curves
(SURVEY.md §5 "Metrics/logging"); the build contract upgrades this to
structured JSONL rows (one object per line, machine-readable) plus the same
human-readable stdout stream.

Every row carries the shared obs/ envelope (schema version, absolute ``ts``
wall clock, ``host`` process index — obs/schema.py) and is STRICT JSON:
``json.dumps(float("nan"))`` emits bare ``NaN``, which is invalid JSON and
broke downstream parsers on the fault rows, so non-finite floats are
sanitized (NaN -> null, +/-inf -> "inf"/"-inf") before serialisation.

Observers: ``add_observer(fn)`` registers a callback invoked with every
sanitized row — obs/health.RunHealth uses this to fold fault/serve rows into
the run's health state without coupling to their emitters.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from rainbow_iqn_apex_tpu_torch.obs.schema import SCHEMA_VERSION, sanitize


class MetricsLogger:
    """Append-only JSONL metrics with wall-clock stamps and an FPS meter."""

    def __init__(
        self,
        path: Optional[str],
        run_id: str = "run",
        echo: bool = True,
        host: int = 0,
    ):
        self.path = path
        self.echo = echo
        self.run_id = run_id
        self.host = int(host)
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()
        self._last_t: Optional[float] = None
        self._last_frames = 0
        self._observers: List[Callable[[Dict[str, Any]], None]] = []

    def add_observer(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        """Register a callback receiving every sanitized row dict."""
        self._observers.append(fn)

    def log(self, kind: str, **fields: Any) -> Dict[str, Any]:
        now = time.time()
        row = sanitize(
            {
                "t": round(now - self._t0, 3),
                "ts": round(now, 3),
                "host": self.host,
                "run": self.run_id,
                "kind": kind,
                "schema": SCHEMA_VERSION,
                **fields,
            }
        )
        if self._fh:
            # allow_nan=False is the backstop: sanitize() already cleared
            # non-finite floats, so a bare NaN can never reach the file
            self._fh.write(json.dumps(row, allow_nan=False) + "\n")
        for fn in self._observers:
            try:
                fn(row)
            except Exception:
                pass  # a broken observer must never kill the training loop
        if self.echo:
            skip = ("t", "ts", "host", "run", "kind", "schema")
            pretty = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items()
                if k not in skip
            )
            print(f"[{row['t']:9.1f}s] {kind:8s} {pretty}", file=sys.stderr)
        return row

    def fps(self, frames: int) -> float:
        """Rolling frames/sec between successive calls."""
        now = time.time()
        if self._last_t is None:
            self._last_t, self._last_frames = now, frames
            return 0.0
        dt = max(now - self._last_t, 1e-9)
        fps = (frames - self._last_frames) / dt
        self._last_t, self._last_frames = now, frames
        return fps

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
