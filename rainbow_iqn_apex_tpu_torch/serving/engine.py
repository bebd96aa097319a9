"""Bucketed inference engine: the device half of the port's policy server.

Counterpart of ``rainbow_iqn_apex_tpu/serving/engine.py`` (:64-305) on one
CUDA device.  Request batches are padded to one of a few fixed bucket sizes
(repeating row 0, so the padded rows' compute stays on the live numeric
path) and dispatched through the act step of ``ops/act.py``, whose forward
runs the port's kernels.

Hot swap: ``load_params`` stages a complete new network on the device under
the swap lock, then swaps one Python reference.  A dispatch in flight keeps
the network it started with (its tensors stay alive while referenced, and
all work is ordered on one stream), the next dispatch reads the new one, and
no request observes a half-written set of weights.

Not ported (each raises NotImplementedError): quantized serving
(``serve_quantize != "off"``) and more than one device.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.ops.act import (
    DeviceLike,
    build_act_step,
    load_network,
    resolve_device,
)
from rainbow_iqn_apex_tpu_torch.serving.batcher import pick_bucket


def fit_buckets(buckets: Sequence[int], n_devices: int) -> List[int]:
    """Round each requested bucket up to a multiple of the device count and
    dedupe; order stays ascending."""
    fitted = sorted({max(-(-int(b) // n_devices) * n_devices, n_devices)
                     for b in buckets})
    if not fitted:
        raise ValueError("need at least one batch bucket")
    return fitted


def parse_buckets(spec: str) -> List[int]:
    """Parse "8,16,32,64" into [8, 16, 32, 64]."""
    out = [int(p) for p in str(spec).split(",") if p.strip()]
    if not out:
        raise ValueError(f"no batch buckets in {spec!r}")
    return out


def single_device(device: Any) -> DeviceLike:
    """Accept one device, or a sequence holding exactly one."""
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise NotImplementedError(
                "the port serves on one device; multi-device serving is not ported")
        return device[0]
    return device


class InferenceEngine:
    """Bucketed policy inference on one device with atomically swappable
    params.

    mode: "greedy" acts without noisy-net noise (eval-time behaviour);
    "noisy" keeps the noise on.  Taus are drawn fresh per dispatch in both
    modes, from a per-engine generator seeded ``cfg.seed + 4099``.
    """

    def __init__(
        self,
        cfg: Config,
        num_actions: int,
        params: Mapping[str, torch.Tensor],
        device: DeviceLike = None,
        buckets: Optional[Sequence[int]] = None,
        mode: str = "greedy",
        state_shape: Optional[Tuple[int, int, int]] = None,
    ):
        if mode not in ("greedy", "noisy"):
            raise ValueError(f"unknown serve mode {mode!r}")
        if getattr(cfg, "serve_quantize", "off") != "off":
            raise NotImplementedError(
                f"serve_quantize={cfg.serve_quantize!r}: quantized serving (K10) "
                "is not ported yet; use 'off'")
        self.cfg = cfg
        self.num_actions = num_actions
        self.mode = mode
        self.device = resolve_device(single_device(device))
        self.state_shape = tuple(state_shape or cfg.state_shape)
        self.buckets = fit_buckets(
            buckets if buckets is not None else parse_buckets(cfg.serve_batch_buckets), 1)
        self._use_noise = mode == "noisy"
        self._act = build_act_step(cfg, num_actions, use_noise=self._use_noise)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(cfg.seed + 4099)
        self._gen_lock = threading.Lock()
        self._swap_lock = threading.Lock()
        self._net = self._stage(params)
        self.params_version = 0
        self.weights_loaded_at = time.monotonic()

    def _stage(self, params: Mapping[str, torch.Tensor]):
        return load_network(self.cfg, self.num_actions, params, self.device,
                            use_noise=self._use_noise, state_shape=self.state_shape)

    # ------------------------------------------------------------- hot swap
    def load_params(self, params: Mapping[str, torch.Tensor]) -> int:
        """Stage ``params`` on the device, then atomically swap the reference
        the next dispatch reads.  Safe from any thread while inference runs;
        returns the new params version.  Staging happens under the swap lock
        so concurrent swaps land in call order."""
        with self._swap_lock:
            self._net = self._stage(params)
            self.params_version += 1
            self.weights_loaded_at = time.monotonic()
            return self.params_version

    def weights_age_s(self) -> float:
        """Seconds since the served weights last changed."""
        return time.monotonic() - self.weights_loaded_at

    @property
    def params(self):
        """The live network (the params holder)."""
        return self._net

    # ------------------------------------------------------------ inference
    def bucket_for(self, n: int) -> int:
        return pick_bucket(self.buckets, n)

    def infer(self, obs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """obs [n, H, W, C] uint8, n <= max bucket -> (actions [n], q [n, A]).

        Pads to the smallest bucket by repeating row 0 and slices the padding
        back off on the host."""
        n = obs.shape[0]
        bucket = self.bucket_for(n)
        if bucket != n:
            pad = np.broadcast_to(obs[:1], (bucket - n, *obs.shape[1:]))
            obs = np.concatenate([obs, pad], axis=0)
        obs_t = torch.from_numpy(np.ascontiguousarray(obs)).to(self.device)
        net = self._net
        with self._gen_lock:
            actions, q = self._act(net, obs_t, self._generator)
        return actions.cpu().numpy()[:n], q.cpu().numpy()[:n]
