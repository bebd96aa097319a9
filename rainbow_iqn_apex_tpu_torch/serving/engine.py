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

Quantized serving (``cfg.serve_quantize`` "int8" or "fp8", engine.py
:123-250 of the JAX package): every stage also quantizes the fp32 weights
(K10q) into a ``QuantizedIQN`` (``models/quantized.py``: K10d, K2, K10g,
K4), and a gate compares its greedy actions with the full-precision
network's on the calibration batch.  Agreement at or above
``cfg.quant_agreement_min`` makes the quantized network serve; below it the
engine serves the full-precision one and emits one reasoned
``quant_fallback`` row through ``quant_log``.  The gate draws its taus and
noise once from its own generator, seeded ``cfg.seed + 8221`` anew for
each gate, and hands the same draws to both networks; it never advances
the dispatch generator.  The quantized network stays local until the gate
has passed, so a dispatch never serves unvetted weights.

Not ported (raises NotImplementedError): more than one device.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.ops.act import (
    DeviceLike,
    build_act_step,
    load_network,
    resolve_device,
)
from rainbow_iqn_apex_tpu_torch.models.quantized import QuantizedIQN, make_quantized_network
from rainbow_iqn_apex_tpu_torch.serving.batcher import pick_bucket
from rainbow_iqn_apex_tpu_torch.utils.quantize import (
    check_mode,
    greedy_agreement,
    quantize_params,
)


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

    ``calib_obs`` ([n, H, W, C] uint8) is the quantization gate's
    calibration batch and ``quant_log(kind, **fields)`` receives its
    ``quant`` / ``quant_fallback`` rows; both matter only with
    ``cfg.serve_quantize`` on.  Without a calibration batch the quantized
    network stays off quietly (the gate cannot be evaluated).
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
        calib_obs: Optional[np.ndarray] = None,
        quant_log: Optional[Callable[..., Any]] = None,
    ):
        if mode not in ("greedy", "noisy"):
            raise ValueError(f"unknown serve mode {mode!r}")
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
        self.quant_mode = check_mode(getattr(cfg, "serve_quantize", "off"))
        self.quant_agreement_min = float(getattr(cfg, "quant_agreement_min", 0.99))
        self.quant_log = quant_log
        self.quant_active = False
        self.quant_agreement: Optional[float] = None
        self.quant_fallbacks = 0
        self._qnet: Optional[QuantizedIQN] = None
        self._calib_obs = None if calib_obs is None else np.asarray(calib_obs)
        self._net = self._stage(params)
        self._serving = self._net  # the network dispatches read: _net or a vetted _qnet
        self.params_version = 0
        if self.quant_mode != "off":
            self._stage_quantized(params)
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
            if self.quant_mode != "off":
                self._stage_quantized(params)
            else:
                self._serving = self._net
            self.params_version += 1
            self.weights_loaded_at = time.monotonic()
            return self.params_version

    # ------------------------------------------------- quantized inference
    def set_calibration(self, calib_obs: np.ndarray) -> None:
        """Provide or replace the calibration observations ([n, H, W, C]
        uint8) and re-run the gate on the staged weights."""
        self._calib_obs = np.asarray(calib_obs)
        if self.quant_mode != "off":
            with self._swap_lock:
                self._stage_quantized(self._params32)

    def _emit_quant(self, kind: str, **fields: Any) -> None:
        if self.quant_log is not None:
            try:
                self.quant_log(kind, **fields)
            except Exception:
                pass  # observability must never block a swap

    def _gate_draws(self, batch: int):
        """The gate's taus (and noise, in noisy mode), drawn from a generator
        seeded ``cfg.seed + 8221`` anew for each gate."""
        g = torch.Generator(device=self.device).manual_seed(self.cfg.seed + 8221)
        taus = torch.rand((batch, self.cfg.num_quantile_samples), generator=g,
                          device=self.device)
        return taus, (self._net.sample_noise(g) if self._use_noise else None)

    def _stage_quantized(self, params: Mapping[str, torch.Tensor]) -> None:
        """Quantize the fp32 ``params`` (K10q) and gate them; called under
        the swap lock.  The quantized network serves only after the gate
        passed; until it has ruled, dispatches keep the network they served
        before (stale, as in a hot swap, but vetted)."""
        self._params32 = params
        fp32 = {k: torch.as_tensor(v).detach().to(self.device, torch.float32).contiguous()
                for k, v in params.items()}
        qnet = make_quantized_network(self.cfg, self.num_actions,
                                      quantize_params(fp32, self.quant_mode),
                                      use_noise=self._use_noise)
        if self._calib_obs is None:
            self.quant_active = False
            self._qnet = qnet  # unused while inactive; kept fresh
            self._serving = self._net
            return
        # clamp to the largest bucket and pad as live traffic pads
        obs = self._calib_obs[: self.buckets[-1]]
        n = obs.shape[0]
        bucket = self.bucket_for(n)
        if bucket != n:
            pad = np.broadcast_to(obs[:1], (bucket - n, *obs.shape[1:]))
            obs = np.concatenate([obs, pad], axis=0)
        obs_t = torch.from_numpy(np.ascontiguousarray(obs)).to(self.device)
        taus, noise = self._gate_draws(bucket)
        a32, _ = self._act(self._net, obs_t, None, taus, noise)
        aq, _ = self._act(qnet, obs_t, None, taus, noise)
        agreement = greedy_agreement(a32.cpu().numpy()[:n], aq.cpu().numpy()[:n])
        self.quant_agreement = agreement
        self._qnet = qnet
        if agreement >= self.quant_agreement_min:
            self.quant_active = True
            self._serving = qnet
            self._emit_quant(
                "quant", event="gate", mode=self.quant_mode, active=True,
                agreement=round(agreement, 6), threshold=self.quant_agreement_min,
                calib_batch=int(n))
        else:
            was_active = self.quant_active
            self.quant_active = False
            self._serving = self._net
            self.quant_fallbacks += 1
            self._emit_quant(
                "quant_fallback", reason="agreement_below_min", mode=self.quant_mode,
                agreement=round(agreement, 6), threshold=self.quant_agreement_min,
                calib_batch=int(n), was_active=was_active)

    def quant_state(self) -> dict:
        """Live quantization status (healthz / stats surface)."""
        return {
            "quant_mode": self.quant_mode,
            "quant_active": self.quant_active,
            "quant_agreement": self.quant_agreement,
            "quant_fallbacks": self.quant_fallbacks,
        }

    def weights_age_s(self) -> float:
        """Seconds since the served weights last changed."""
        return time.monotonic() - self.weights_loaded_at

    @property
    def params(self):
        """The live full-precision network (the params holder)."""
        return self._net

    @property
    def quantized(self) -> Optional[QuantizedIQN]:
        """The quantized network of the last stage (serving iff
        ``quant_active``), or None with ``serve_quantize`` off."""
        return self._qnet

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
        net = self._serving
        with self._gen_lock:
            actions, q = self._act(net, obs_t, self._generator)
        return actions.cpu().numpy()[:n], q.cpu().numpy()[:n]
