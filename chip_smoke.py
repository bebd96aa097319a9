#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (rainbow_iqn_apex_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``rainbow_iqn_apex_tpu_torch/csrc``
and runs every phase, in this order:

- ``kernels``: the serving kernels (K2, K3, K4) against their plain PyTorch
  twins at the full-width serving shapes (bucket 64, K = 32 taus, F = 3136,
  hidden 512, 18 actions, bf16), timed beside the twin, the bound and the
  nearest single PyTorch call;
- ``serve``: the port's ``PolicyServer`` from ``configs/serve_defaults.json``
  with seeded random weights, 512 requests from 8 client threads, launch
  counters that prove the path went through every serving kernel, a
  profile, the kernel path against the plain path (greedy and noisy), a
  weight hot-swap and a draining stop;
- ``kernels_learn``: the learner's kernels (K1, K2-bwd, K3-bwd, K4 gather,
  K4-bwd) against their twins at the learner's full-width shapes (B 32,
  N 64), timed the same way;
- ``learn``: 200 full-width learn steps from
  ``configs/reference_atari_defaults.json`` (synthetic frames) through the
  port's ``Agent``, ``PrioritizedReplay`` and write-back ring under
  ``forbid_host_sync()``, with launch counters, then a profile of 20 steps;
- ``learn_parity``: one full-width learn step on the card against the same
  step through the plain twins on the CPU;
- ``train``: ``python -m rainbow_iqn_apex_tpu_torch.train`` on ``toy:catch``
  for 4,000 frames, held to an evaluation score above 0.2.

One JSON object per line; the line before the last is the card's name and
power limit from ``nvidia-smi``, and the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
those lines.  Without a CUDA device, or without the port beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 123
BUCKET = 64
REQUESTS = 512
CLIENTS = 8
REPS = 60  # timed replays per measurement (median reported)
CALLS_PER_REPLAY = 10  # launches captured per CUDA-graph replay
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
BF16_FLOPS = 989e12  # H100 SXM dense bf16, published
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores, published
K2_TOL = dict(atol=1e-2, rtol=1e-2)  # bf16 output: one ulp is 2^-8 relative
K3_TOL = dict(atol=2e-3, rtol=2e-3)  # fp32 sums of up to 3136 products, other order
K4_TOL = dict(atol=1e-5, rtol=1e-5)  # fp32, summation order only
PATH_TOL = 3e-2  # quantiles, kernel path (card) vs plain path (CPU), bf16 model
PATH_Q_TOL = 2e-3  # their means over tau; actions must agree where the gap > 2x this
K1_TOL = dict(atol=1e-5, rtol=1e-5)  # fp32 loss, td and gradient, summation order only
K1_OPS_PER_PAIR = 16  # flops per (i, j) pair in the loss, |u|, weight and gradient
K2B_TOL = dict(atol=1e-2, rtol=1e-2)  # bf16 results of fp32 sums in another order: ~1 ulp
K3B_TOL = dict(atol=1e-2, rtol=1e-2)  # bf16 dx / dW (fp32 sums, split dy); db fp32
K4B_TOL = dict(atol=1e-6, rtol=1e-6)  # fp32, one product and one subtraction per element
SERVE_KERNELS = ("K2_tau_embed", "K3_noisy_linear", "K4_dueling_head")  # the serving path's
LEARN_STEPS = 200  # steady-state learn steps of the `learn` phase
LEARN_WARMUP = 10  # steps before it (first-call costs, pinned buffers)
LEARN_LANES = 16  # replay lanes, as configs/reference_atari_defaults.json
LEARN_FILL = 512  # env ticks of synthetic frames per lane (8,192 transitions)
LEARN_CAPACITY = 16 * 1024  # replay slots (the config's 1,000,000 is 7 GB of host RAM)
LEARN_TARGET_PERIOD = 100  # so a target copy falls inside the run (config: 8,000)
PROFILE_STEPS = 20
# learn_parity: one full-width step, kernels (card) vs plain twins (CPU), bf16
# model: loss, priorities and q means within the model's quantile tolerance
LEARN_PATH_TOL = dict(rtol=2e-2, atol=PATH_TOL)
LEARN_GNORM_RTOL = 2e-2  # the gradient's global norm, bf16 cotangents
LEARN_UPDATE_RTOL = 5e-2  # each tensor's Adam update, relative L2 (bf16 gradients)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing
def time_ms(torch, fn) -> float:
    """Median device time of one ``fn()`` in ms: CALLS_PER_REPLAY calls are
    captured in a CUDA graph (so host launch overhead is not timed), and each
    of REPS replays is bracketed by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS_PER_REPLAY):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        samples.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) / CALLS_PER_REPLAY for s, e in samples)
    return times[len(times) // 2]


def bound_ms(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def errors(torch, got, want, tol):
    diff = (got.float() - want.float()).abs()
    max_abs = diff.max().item()
    max_rel = (diff / want.float().abs().clamp_min(1e-6)).max().item()
    ok = bool(torch.all(diff <= tol["atol"] + tol["rtol"] * want.float().abs()).item())
    return max_abs, max_rel, ok


# ------------------------------------------------------------------ phases
def phase_kernels(torch, cfg):
    """Each kernel against its plain twin at the bucket-64 full-width shapes."""
    from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import dueling_head, dueling_head_plain
    from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear import noisy_linear, noisy_linear_plain
    from rainbow_iqn_apex_tpu_torch.kernels.tau_embed import tau_embed, tau_embed_plain
    from rainbow_iqn_apex_tpu_torch.models.layers import _f, trunk_features

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    batch, taus_n = BUCKET, cfg.num_quantile_samples
    m, feat, cos_n = batch * taus_n, trunk_features(cfg.frame_height, cfg.frame_width), cfg.num_cosines
    hidden, actions = cfg.hidden_size, 18

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    results = {}

    # K2 -----------------------------------------------------------------
    taus = torch.rand((batch, taus_n), generator=gen, device=dev)
    w_e = randn(feat, cos_n, scale=cos_n ** -0.5, dtype=bf)
    b_e = randn(feat, scale=0.1)
    phi = randn(batch, feat).relu().to(bf)
    args = (taus, w_e, b_e, phi)
    got, want = tau_embed(*args), tau_embed_plain(*args)
    torch.cuda.synchronize()
    max_abs, max_rel, ok = errors(torch, got, want, K2_TOL)
    nbytes = m * 4 + feat * cos_n * 2 + feat * 4 + batch * feat * 2 + m * feat * 2
    bms, by = bound_ms(nbytes, 2 * m * feat * cos_n, BF16_FLOPS)
    k_ms, p_ms = time_ms(torch, lambda: tau_embed(*args)), time_ms(torch, lambda: tau_embed_plain(*args))
    emit({"phase": "kernels", "kernel": "K2_tau_embed", "shape": [m, feat, cos_n],
          "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": K2_TOL, "ok": ok,
          "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": bms})
    check(ok, f"K2 disagrees with its plain twin: max abs {max_abs}")
    results["K2_tau_embed"] = dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms,
                                   bound_ms=bms, bound_by=by, library_ms=None)

    # K3: every (N, noise, ReLU) the serving path can ask for -------------
    x_hidden = randn(m, feat, dtype=bf)
    x_out = randn(m, hidden).relu().to(bf)
    layers = {}
    for n, x in ((hidden, x_hidden), (actions, x_out), (1, x_out)):
        k = x.shape[1]
        layers[n] = dict(
            x=x, w_mu=randn(n, k, scale=k ** -0.5, dtype=bf), b_mu=randn(n, scale=0.1),
            w_sigma=(randn(n, k).abs() * 0.5 * k ** -0.5).to(bf),
            b_sigma=randn(n).abs() * 0.5 * k ** -0.5,
            f_in=_f(randn(k)), f_out=_f(randn(n)))
    k3 = {}
    k3_max_abs = 0.0
    for n, p in layers.items():
        k = p["x"].shape[1]
        for noisy in (False, True):
            for relu in (False, True):
                a = [p["x"], p["w_mu"], p["b_mu"]]
                if noisy:
                    a += [p["w_sigma"], p["b_sigma"], p["f_in"], p["f_out"]]
                got = noisy_linear(*a, relu=relu)
                want = noisy_linear_plain(*a, relu=relu)
                torch.cuda.synchronize()
                max_abs, max_rel, ok = errors(torch, got, want, K3_TOL)
                k3_max_abs = max(k3_max_abs, max_abs)
                products = 2 if noisy else 1
                nbytes = (m * k * 2 + products * n * k * 2 + products * n * 4 + m * n * 4
                          + (k * 4 + n * 4 if noisy else 0))
                bms, by = bound_ms(nbytes, products * 2 * m * n * k, BF16_FLOPS)
                k_ms = time_ms(torch, lambda: noisy_linear(*a, relu=relu))
                p_ms = time_ms(torch, lambda: noisy_linear_plain(*a, relu=relu))
                lib_ms = None
                if not noisy:
                    b_bf = p["b_mu"].to(bf)
                    lib_ms = time_ms(torch, lambda: torch.nn.functional.linear(p["x"], p["w_mu"], b_bf))
                emit({"phase": "kernels", "kernel": "K3_noisy_linear", "shape": [m, k, n],
                      "noisy": noisy, "relu": relu, "max_abs_err": max_abs,
                      "max_rel_err": max_rel, "tol": K3_TOL, "ok": ok, "kernel_ms": k_ms,
                      "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": bms, "bound_by": by})
                check(ok, f"K3 (N={n}, noisy={noisy}, relu={relu}) disagrees: max abs {max_abs}")
                k3[(n, noisy, relu)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                            bound_ms=bms, bound_by=by)
    # the greedy main path per dispatch: two hidden layers (ReLU), value_out, advantage_out
    path = [k3[(hidden, False, True)], k3[(hidden, False, True)],
            k3[(1, False, False)], k3[(actions, False, False)]]
    results["K3_noisy_linear"] = dict(
        max_abs_err=k3_max_abs,
        **{key: sum(c[key] for c in path) for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by=path[0]["bound_by"])

    # K4 -----------------------------------------------------------------
    value, adv = randn(m, 1), randn(m, actions)
    got, want = dueling_head(value, adv, taus_n), dueling_head_plain(value, adv, taus_n)
    torch.cuda.synchronize()
    max_abs, max_rel, ok = 0.0, 0.0, True
    for g, w in zip(got[:2], want[:2]):
        a_err, r_err, good = errors(torch, g, w, K4_TOL)
        max_abs, max_rel, ok = max(max_abs, a_err), max(max_rel, r_err), ok and good
    top2 = torch.sort(want[1], dim=-1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > K4_TOL["atol"]
    ok = ok and bool(torch.equal(got[2][clear], want[2][clear]))
    tie = torch.zeros((4 * 3, 5), device=dev)
    tie[:, 2] = tie[:, 4] = 1.0
    ok = ok and dueling_head(torch.zeros((4 * 3, 1), device=dev), tie, 3)[2].tolist() == [2] * 4
    nbytes = m * 4 + 2 * m * actions * 4 + batch * actions * 4 + batch * 4
    bms, by = bound_ms(nbytes, 4 * m * actions, FP32_FLOPS)
    k_ms = time_ms(torch, lambda: dueling_head(value, adv, taus_n))
    p_ms = time_ms(torch, lambda: dueling_head_plain(value, adv, taus_n))
    emit({"phase": "kernels", "kernel": "K4_dueling_head", "shape": [batch, taus_n, actions],
          "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": K4_TOL, "ok": ok,
          "kernel_ms": k_ms,
          "plain_ms": p_ms, "library_ms": None, "bound_ms": bms})
    check(ok, f"K4 disagrees with its plain twin (max abs {max_abs}) or breaks a tie wrongly")
    results["K4_dueling_head"] = dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms,
                                      bound_ms=bms, bound_by=by, library_ms=None)
    return results


def phase_kernels_learn(torch, cfg):
    """Each learner kernel (K1, K2-bwd, K3-bwd, K4 gather + K4-bwd) against its
    plain twin at the full-width learner shapes: B = 32, N = N' = 64, F = 3136,
    C = 64, hidden 512, 18 actions, M = B * N = 2048."""
    from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import (
        dueling_gather,
        dueling_gather_bwd,
        dueling_gather_bwd_plain,
        dueling_gather_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear import (
        noisy_linear_bwd,
        noisy_linear_bwd_plain,
        noisy_linear_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.quantile_huber import (
        quantile_huber,
        quantile_huber_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.tau_embed import (
        _cos_features,
        tau_embed_bwd,
        tau_embed_bwd_plain,
    )
    from rainbow_iqn_apex_tpu_torch.models.layers import _f, trunk_features

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf = torch.bfloat16
    batch, n, n_t = cfg.batch_size, cfg.num_tau_samples, cfg.num_tau_prime_samples
    m, feat, cos_n = batch * n, trunk_features(cfg.frame_height, cfg.frame_width), cfg.num_cosines
    hidden, actions = cfg.hidden_size, 18

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def check_all(pairs, tol):
        worst_abs, worst_rel, ok = 0.0, 0.0, True
        for got, want in pairs:
            a, r, good = errors(torch, got, want, tol)
            worst_abs, worst_rel, ok = max(worst_abs, a), max(worst_rel, r), ok and good
        return worst_abs, worst_rel, ok

    def worst_element(pairs):
        """|reference| where the largest absolute error sits, and that error
        in units of the bf16 spacing there (bf16 outputs only)."""
        worst, at, ulps = -1.0, None, None
        for got, want in pairs:
            diff = (got.float() - want.float()).abs().flatten()
            i = int(diff.argmax())
            if float(diff[i]) > worst:
                worst, at = float(diff[i]), float(want.float().flatten()[i].abs())
                ulps = (worst / 2.0 ** (math.floor(math.log2(at)) - 7)
                        if got.dtype == bf and at > 0 else None)
        return at, ulps

    def report(name, shape, tol, fn, plain, lib, nbytes, ops, peak, extra=None):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        max_abs, max_rel, ok = check_all(zip(got, want), tol)
        err_at, err_ulps = worst_element(zip(got, want))
        bms, by = bound_ms(nbytes, ops, peak)
        k_ms, p_ms = time_ms(torch, fn), time_ms(torch, plain)
        lib_ms = None if lib is None else time_ms(torch, lib)
        emit({"phase": "kernels_learn", "kernel": name, "shape": shape, **(extra or {}),
              "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": tol, "ok": ok,
              "max_err_at_abs_ref": err_at, "max_err_bf16_ulps": err_ulps,
              "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": bms,
              "bound_by": by})
        check(ok, f"{name} {extra or ''} disagrees with its plain twin: max abs {max_abs}")
        return dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                    bound_ms=bms, bound_by=by)

    results = {}

    # K1 ------------------------------------------------------------------
    online, taus_o = randn(batch, n), torch.rand((batch, n), generator=gen, device=dev)
    target = randn(batch, n_t)
    target[0, :8] = online[0, :8]  # u == 0 pairs
    target[1, :8] = online[1, :8] + cfg.kappa  # |u| == kappa pairs (the quadratic branch)
    k1 = (online, taus_o, target, cfg.kappa)
    results["K1_quantile_huber"] = report(
        "K1_quantile_huber", [batch, n, n_t], K1_TOL,
        lambda: quantile_huber(*k1), lambda: quantile_huber_plain(*k1), None,
        nbytes=(2 * batch * n + batch * n_t) * 4 + (2 * batch + batch * n) * 4,
        ops=K1_OPS_PER_PAIR * batch * n * n_t, peak=FP32_FLOPS)

    # K2-bwd ------------------------------------------------------------------
    taus = torch.rand((batch, n), generator=gen, device=dev)
    w_e = randn(feat, cos_n, scale=cos_n ** -0.5, dtype=bf)
    b_e = randn(feat, scale=0.1)
    phi = randn(batch, feat).relu().to(bf)
    dh = randn(m, feat, dtype=bf)
    k2 = (taus, w_e, b_e, phi, dh)
    dpre = randn(m, feat, dtype=bf)
    cos_m = _cos_features(taus, cos_n, bf).reshape(m, cos_n)
    results["K2_tau_embed_bwd"] = report(
        "K2_tau_embed_bwd", [m, feat, cos_n], K2B_TOL,
        lambda: tau_embed_bwd(*k2), lambda: tau_embed_bwd_plain(*k2),
        lambda: torch.matmul(dpre.t(), cos_m),
        nbytes=(m * 4 + feat * cos_n * 2 + feat * 4 + batch * feat * 2 + m * feat * 2
                + batch * feat * 2 + feat * cos_n * 2 + feat * 4),
        ops=2 * 2 * m * feat * cos_n, peak=BF16_FLOPS)

    # K3-bwd: the learner's noisy layers ------------------------------------
    k3 = {}
    k3_max_abs = 0.0
    x_hidden = randn(m, feat, dtype=bf)
    x_out = randn(m, hidden).relu().to(bf)
    for name, x, n_out, relu in (("hidden", x_hidden, hidden, True),
                                 ("value_out", x_out, 1, False),
                                 ("advantage_out", x_out, actions, False)):
        k = x.shape[1]
        w_mu = randn(n_out, k, scale=k ** -0.5, dtype=bf)
        w_sigma = (randn(n_out, k).abs() * 0.5 * k ** -0.5).to(bf)
        f_in, f_out = _f(randn(k)), _f(randn(n_out))
        g = randn(m, n_out)
        y = noisy_linear_plain(x, w_mu, randn(n_out, scale=0.1), w_sigma,
                               randn(n_out).abs() * 0.5 * k ** -0.5, f_in, f_out,
                               relu=True) if relu else None
        args = (g, y, x, w_mu, w_sigma, f_in, f_out)
        g_b, dys_b = g.to(bf), (g * f_out).to(bf)
        xe = (x * f_in.to(bf))

        def lib(g_b=g_b, dys_b=dys_b, x=x, xe=xe, w_mu=w_mu, w_sigma=w_sigma):
            torch.matmul(g_b, w_mu)
            torch.matmul(dys_b, w_sigma)
            torch.matmul(g_b.t(), x)
            torch.matmul(dys_b.t(), xe)

        res = report(
            "K3_noisy_linear_bwd", [m, k, n_out], K3B_TOL,
            lambda: noisy_linear_bwd(*args), lambda: noisy_linear_bwd_plain(*args), lib,
            nbytes=(m * n_out * 4 * (2 if relu else 1) + m * k * 2 + 2 * n_out * k * 2
                    + (k + n_out) * 4 + m * k * 2 + 2 * n_out * k * 2 + 2 * n_out * 4),
            ops=4 * 2 * m * n_out * k, peak=BF16_FLOPS,
            extra={"layer": name, "noisy": True, "relu": relu})
        k3_max_abs = max(k3_max_abs, res["max_abs_err"])
        k3[name] = res
    # one learn step runs it on two hidden layers and the two out layers
    path = [k3["hidden"], k3["hidden"], k3["value_out"], k3["advantage_out"]]
    results["K3_noisy_linear_bwd"] = dict(
        max_abs_err=k3_max_abs,
        **{key: sum(c[key] for c in path) for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by=k3["hidden"]["bound_by"])

    # K4: gather mode (checked here, timed in K4's row) and K4-bwd -------------
    value, adv = randn(m, 1), randn(m, actions)
    take = torch.randint(0, actions, (batch,), generator=gen, device=dev, dtype=torch.int32)
    got, want = dueling_gather(value, adv, n, take), dueling_gather_plain(value, adv, n, take)
    torch.cuda.synchronize()
    g_abs, g_rel, g_ok = check_all(zip(got, want), K4_TOL)
    bad = take.clone()
    bad[0] = actions  # out of range: NaN, as jnp's take_along_axis fill mode gives
    nan_row = bool(torch.isnan(dueling_gather(value, adv, n, bad)[0][0]).all().item())
    emit({"phase": "kernels_learn", "kernel": "K4_dueling_head", "mode": "gather",
          "max_abs_err": g_abs, "max_rel_err": g_rel, "tol": K4_TOL, "ok": g_ok,
          "out_of_range_gives_nan": nan_row})
    check(g_ok and nan_row, f"K4 gather mode disagrees with its twin (max abs {g_abs}) "
          "or an out-of-range action did not give NaN")
    dz = randn(batch, n)
    k4 = (dz, take, actions, True)
    results["K4_dueling_head_bwd"] = report(
        "K4_dueling_head_bwd", [batch, n, actions], K4B_TOL,
        lambda: dueling_gather_bwd(*k4), lambda: dueling_gather_bwd_plain(*k4), None,
        nbytes=batch * n * 4 + batch * 4 + m * 4 + m * actions * 4,
        ops=2 * m * actions, peak=FP32_FLOPS)
    return results


def _learn_cfg(cfg):
    """The reference Atari config with the `learn` phase's cuts (printed)."""
    return cfg.replace(memory_capacity=LEARN_CAPACITY, learn_start=LEARN_LANES * LEARN_FILL // 2,
                       target_update_period=LEARN_TARGET_PERIOD, stall_timeout_s=0.0,
                       role="single")


def _fill_replay(cfg, np):
    """The port's PrioritizedReplay filled across the lanes with seeded
    random 84x84 uint8 frames, actions, rewards and terminals."""
    from rainbow_iqn_apex_tpu_torch.replay import PrioritizedReplay

    memory = PrioritizedReplay(
        cfg.memory_capacity, (cfg.frame_height, cfg.frame_width), history=cfg.history_length,
        n_step=cfg.multi_step, gamma=cfg.gamma, lanes=LEARN_LANES,
        priority_exponent=cfg.priority_exponent, priority_eps=cfg.priority_eps, seed=cfg.seed,
        use_native=cfg.use_native_sumtree)
    rng = np.random.default_rng(SEED)
    for _ in range(LEARN_FILL):
        memory.append_batch(
            rng.integers(0, 256, (LEARN_LANES, cfg.frame_height, cfg.frame_width), dtype=np.uint8),
            rng.integers(0, 18, LEARN_LANES), rng.normal(size=LEARN_LANES).astype(np.float32),
            rng.random(LEARN_LANES) < 0.01)
    return memory


def phase_learn(torch, cfg):
    """The full-width learner through the port's entry points: Agent,
    PrioritizedReplay, the prefetcher and the write-back ring, LEARN_STEPS
    steps with the steady state under forbid_host_sync(), then a profile of
    PROFILE_STEPS more."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.agents import Agent
    from rainbow_iqn_apex_tpu_torch.kernels import launches, reset_launches
    from rainbow_iqn_apex_tpu_torch.parallel.supervisor import TrainSupervisor
    from rainbow_iqn_apex_tpu_torch.train import priority_beta
    from rainbow_iqn_apex_tpu_torch.utils import hostsync
    from rainbow_iqn_apex_tpu_torch.utils.prefetch import make_replay_prefetcher
    from rainbow_iqn_apex_tpu_torch.utils.writeback import RingCommitter, WritebackRing

    cfg = _learn_cfg(cfg)
    cuts = {"frames": "synthetic seeded uint8 (no emulator on the machine)",
            "memory_capacity": cfg.memory_capacity, "learn_start": cfg.learn_start,
            "target_update_period": cfg.target_update_period}
    t0 = time.perf_counter()
    memory = _fill_replay(cfg, np)
    fill_s = time.perf_counter() - t0
    agent = Agent(cfg, 18, cfg.seed)  # cuda:0 by default
    check(agent.device.type == "cuda", "the agent did not pick the card by default")
    sup = TrainSupervisor(cfg)
    ring = WritebackRing(cfg.writeback_depth)
    committer = RingCommitter(ring, memory.update_priorities, sup, agent.load_snapshot)
    prefetcher = make_replay_prefetcher(memory, cfg, lambda: priority_beta(cfg, 0), agent.device)
    losses, finite = [], []

    def one_step():
        idx, batch = prefetcher.get()
        info = agent.learn_batch(batch)
        retired = ring.push(agent.step, idx, info)
        if retired is not None:
            losses.append(retired.scalars["loss"])
            finite.append(retired.finite)
        return committer.commit(retired)

    try:
        for _ in range(LEARN_WARMUP):
            check(one_step(), "a warm-up learn step was not finite")
        check(committer.drain(), "a warm-up learn step was not finite")
        torch.cuda.synchronize()
        with torch.no_grad():
            target_before = torch.cat([p.flatten() for p in agent.state.target.parameters()])
        step0 = agent.step
        reset_launches()
        lat_ms = []
        t_run = time.perf_counter()
        try:
            with hostsync.forbid_host_sync():
                for _ in range(LEARN_STEPS):
                    t = time.perf_counter()
                    check(one_step(), "a learn step was not finite (rolled back)")
                    lat_ms.append((time.perf_counter() - t) * 1e3)
        except RuntimeError as e:  # CUDA's sync debug mode, or a HostSyncError
            raise SmokeFailure(f"a host sync in the steady-state learn loop: {e}")
        check(committer.drain(), "a learn step was not finite at the drain")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t_run
        counts = dict(launches)
        with torch.no_grad():
            target_after = torch.cat([p.flatten() for p in agent.state.target.parameters()])
        copies = agent.step // cfg.target_update_period - step0 // cfg.target_update_period
        target_moved = not torch.equal(target_before, target_after)
        lat = np.sort(np.asarray(lat_ms))
        emit({"phase": "learn", "steps": LEARN_STEPS, "batch": cfg.batch_size,
              "taus": [cfg.num_quantile_samples, cfg.num_tau_prime_samples, cfg.num_tau_samples],
              "learn_steps_per_s": LEARN_STEPS / elapsed, "seconds": elapsed,
              "step_host_p50_ms": float(lat[len(lat) // 2]),
              "step_host_p99_ms": float(lat[int(0.99 * (len(lat) - 1))]),
              "launches": counts,
              "launches_per_step": {k: v / LEARN_STEPS for k, v in counts.items()},
              "losses_finite": bool(all(np.isfinite(losses)) and all(finite)),
              "retired": len(losses), "target_copies": copies, "target_moved": target_moved,
              "rollbacks": sup.rollbacks, "replay_fill_s": fill_s, "cuts": cuts})
        for name, n in counts.items():
            check(n > 0, f"{name} was never launched on the learn path")
        check(all(np.isfinite(losses)) and all(finite) and len(losses) >= LEARN_STEPS,
              "a non-finite loss in the learn phase")
        check(copies >= 1 and target_moved, "no target copy happened in the learn phase")
        check(sup.rollbacks == 0, "the learn phase rolled back")
        profile_learn(torch, agent, prefetcher, ring, committer)
    finally:
        prefetcher.close()
    return counts


def profile_learn(torch, agent, prefetcher, ring, committer):
    """Where the time of a full-width learn step goes: device time by kernel
    name from torch.profiler over PROFILE_STEPS steps, and the device's idle
    share of the window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            idx, batch = prefetcher.get()
            info = agent.learn_batch(batch)
            committer.commit(ring.push(agent.step, idx, info))
        committer.drain()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(torch, prof)
    device_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    emit({"phase": "profile_learn", "steps": PROFILE_STEPS,
          "wall_us_per_step": wall_us / PROFILE_STEPS,
          "device_us_per_step": device_us / PROFILE_STEPS if rows else "not measured",
          "device_idle_share": 1.0 - device_us / wall_us if rows else "not measured",
          "top": [{"name": k[:80], "us_per_step": t / PROFILE_STEPS, "calls_per_step": c / PROFILE_STEPS}
                  for k, t, c in rows[:15]]})


def phase_learn_parity(torch, cfg):
    """One full-width learn step through the kernels on the card against the
    same step through the plain twins on the CPU: same state (a few steps
    in, so Adam's moments are not zero), batch, taus and noise."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.ops.learn import (
        build_learn_step,
        host_state,
        init_train_state,
        load_host_state,
    )
    from rainbow_iqn_apex_tpu_torch.agents import to_device_batch

    cfg = _learn_cfg(cfg)
    memory = _fill_replay(cfg, np)
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    card = init_train_state(cfg, 18, cfg.seed)
    step = build_learn_step(cfg, 18)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for _ in range(3):  # warm the moments on the card
        card, _ = step(card, to_device_batch(memory.sample(cfg.batch_size, 0.4), dev), gen)
    host = host_state(card)
    plain = load_host_state(init_train_state(cfg, 18, cfg.seed, device="cpu"), host)
    sample = memory.sample(cfg.batch_size, 0.4)
    g = torch.Generator().manual_seed(SEED + 1)
    draws = {}
    for name, n in (("select", cfg.num_quantile_samples), ("target", cfg.num_tau_prime_samples),
                    ("online", cfg.num_tau_samples)):
        taus = torch.rand((cfg.batch_size, n), generator=g)
        noise = {k: (torch.randn(layer.in_features, generator=g),
                     torch.randn(layer.out_features, generator=g))
                 for k, layer in ((k, getattr(plain.net, k)) for k in plain.net.noisy_names)}
        draws[name] = (taus, noise)
    on_card = {k: (t.to(dev), {n: (a.to(dev), b.to(dev)) for n, (a, b) in nz.items()})
               for k, (t, nz) in draws.items()}
    card, k_info = step(card, to_device_batch(sample, dev), draws=on_card)
    t0 = time.perf_counter()
    plain, p_info = step(plain, to_device_batch(sample, cpu), draws=draws)
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    out = {}
    for key in ("loss", "priorities", "q_mean", "target_q_mean"):
        got, want = k_info[key].cpu().double(), p_info[key].double()
        err = (got - want).abs()
        out[key] = float(err.max())
        check(bool(torch.all(err <= LEARN_PATH_TOL["atol"] + LEARN_PATH_TOL["rtol"] * want.abs())),
              f"learn_parity: {key} differs by {out[key]}")
    gn_rel = abs(k_info["grad_norm"].item() - p_info["grad_norm"].item()) / p_info["grad_norm"].item()
    check(gn_rel <= LEARN_GNORM_RTOL, f"learn_parity: grad_norm differs by {gn_rel} relative")
    before = host["params"]
    after_k = {k: v.cpu() for k, v in card.net.state_dict().items()}
    after_p = plain.net.state_dict()
    worst, worst_name = 0.0, ""
    for k in before:
        dk, dp = after_k[k] - before[k], after_p[k] - before[k]
        rel = float((dk - dp).norm() / dp.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, k
    emit({"phase": "learn_parity", "batch": cfg.batch_size, "max_abs_err": out,
          "tol": LEARN_PATH_TOL, "grad_norm_rel_err": gn_rel, "grad_norm_rtol": LEARN_GNORM_RTOL,
          "update_rel_l2_worst": worst, "update_worst_tensor": worst_name,
          "update_rtol": LEARN_UPDATE_RTOL, "finite": [bool(k_info["finite"]), bool(p_info["finite"])],
          "cpu_step_s": cpu_s})
    check(worst <= LEARN_UPDATE_RTOL, f"learn_parity: the update of {worst_name} differs by {worst} (rel L2)")
    check(bool(k_info["finite"]) and bool(p_info["finite"]), "learn_parity: a non-finite step")


def phase_train(torch):
    """The port's training CLI, in process: toy:catch with the scenario of
    tests/test_train_integration.py (_cfg), bf16 (the card's path takes no
    other compute dtype), 4,000 frames; the JAX test's own bar."""
    import contextlib
    import io
    import tempfile

    from rainbow_iqn_apex_tpu_torch.train import main as train_main

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_", dir=ROOT) as tmp:
        argv = ["--role", "single", "--env-id", "toy:catch", "--compute-dtype", "bfloat16",
                "--frame-height", "80", "--frame-width", "80", "--history-length", "2",
                "--hidden-size", "128", "--num-cosines", "32", "--num-tau-samples", "8",
                "--num-tau-prime-samples", "8", "--num-quantile-samples", "8",
                "--batch-size", "32", "--learning-rate", "1e-3", "--adam-eps", "1e-8",
                "--multi-step", "3", "--gamma", "0.9", "--memory-capacity", "8192",
                "--learn-start", "512", "--frames-per-learn", "2",
                "--target-update-period", "200", "--num-envs-per-actor", "8",
                "--metrics-interval", "200", "--eval-interval", "0",
                "--checkpoint-interval", "0", "--eval-episodes", "40", "--seed", "7",
                "--results-dir", os.path.join(tmp, "results"),
                "--checkpoint-dir", os.path.join(tmp, "ckpt"), "--max-frames", "4000"]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = train_main(argv)
        elapsed = time.perf_counter() - t0
    emit({"phase": "train", "env": "toy:catch", "frames": summary["frames"],
          "learn_steps": summary["learn_steps"], "seconds": elapsed,
          "frames_per_s": summary["frames"] / elapsed,
          "learn_steps_per_s": summary["learn_steps"] / elapsed,
          "eval_score_mean": summary["eval_score_mean"],
          "train_return_mean": summary["train_return_mean"], "rollbacks": summary["rollbacks"]})
    check(summary["eval_score_mean"] > 0.2, f"catch eval mean {summary['eval_score_mean']} <= 0.2")
    check(summary["learn_steps"] > 1500, f"only {summary['learn_steps']} learn steps")


def device_rows(torch, prof):
    """(name, device us, calls) of the device-side events: kernels and
    copies.  CPU-side op rows carry the same device time again, and user
    annotations (``Optimizer.step``) span kernels already counted, so both
    would count it twice."""
    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def profile_dispatch(torch, engine, obs, dispatches=20):
    """Where the time of a bucket-64 ``infer`` goes: device time by kernel
    name from torch.profiler, and the device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile

    engine.infer(obs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(dispatches):
            engine.infer(obs)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(torch, prof)
    device_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    emit({"phase": "profile", "bucket": len(obs), "dispatches": dispatches,
          "wall_us_per_dispatch": wall_us / dispatches,
          "device_us_per_dispatch": device_us / dispatches if rows else "not measured",
          "device_idle_share": 1.0 - device_us / wall_us if rows else "not measured",
          "top": [{"name": k[:80], "us_per_dispatch": t / dispatches, "calls": c}
                  for k, t, c in rows[:10]]})


def phase_serve(torch, cfg):
    """The port's main path: PolicyServer at full width, 512 requests."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.kernels import launches, reset_launches
    from rainbow_iqn_apex_tpu_torch.models import init_params
    from rainbow_iqn_apex_tpu_torch.ops import load_network
    from rainbow_iqn_apex_tpu_torch.serving import InferenceEngine, PolicyServer

    actions_n = 18
    params = init_params(cfg, actions_n, seed=SEED)
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (REQUESTS, *cfg.state_shape), dtype=np.uint8)

    server = PolicyServer(cfg, actions_n, params)  # cuda:0 by default
    check(server.engine.device.type == "cuda", "server did not pick the card by default")
    reset_launches()
    t_start = time.perf_counter()
    server.start()  # warms every bucket
    warm_s = time.perf_counter() - t_start
    answers = [None] * REQUESTS
    latency_ms = [0.0] * REQUESTS
    failures = []

    def client(i):
        try:
            for r in range(i, REQUESTS, CLIENTS):
                t = time.perf_counter()
                answers[r] = server.act_values(frames[r], timeout=120)
                latency_ms[r] = (time.perf_counter() - t) * 1e3
        except Exception as e:  # recorded and failed below
            failures.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    elapsed = time.perf_counter() - t0
    counts = dict(launches)  # the main path: start() + 512 requests
    check(not any(t.is_alive() for t in threads), "client threads did not finish")
    check(not failures, f"requests failed: {failures[:3]}")
    check(all(a is not None for a in answers), "a request got no answer")
    acts = np.array([a for a, _ in answers])
    qs = np.stack([q for _, q in answers])
    check(bool(np.all((acts >= 0) & (acts < actions_n))), "action out of range")
    check(qs.shape == (REQUESTS, actions_n) and bool(np.all(np.isfinite(qs))), "bad q values")
    for name in SERVE_KERNELS:
        check(counts[name] > 0, f"{name} was never launched on the serving path")
    stats = server.stats()
    lat = np.sort(np.asarray(latency_ms))
    emit({"phase": "serve", "requests": REQUESTS, "clients": CLIENTS, "seconds": elapsed,
          "requests_per_s": REQUESTS / elapsed, "warmup_s": warm_s, "launches": counts,
          "request_p50_ms": float(lat[len(lat) // 2]),
          "request_p99_ms": float(lat[int(0.99 * (len(lat) - 1))]),
          "request_max_ms": float(lat[-1]),
          "batches": stats["total_batches"], "batch_occupancy": stats["batch_occupancy_lifetime"],
          "total_shed": stats["total_shed"]})

    # per-bucket infer latency (host clock around engine.infer, which ends
    # in the device-to-host copy of the answers)
    engine = server.engine
    for bucket in engine.buckets:
        lat = []
        for r in range(40):
            t = time.perf_counter()
            engine.infer(frames[r * 8 % (REQUESTS - bucket):][:bucket])
            lat.append((time.perf_counter() - t) * 1e3)
        lat = sorted(lat[5:])
        emit({"phase": "serve_bucket", "bucket": bucket, "infer_p50_ms": lat[len(lat) // 2],
              "infer_p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))]})

    profile_dispatch(torch, engine, frames[:BUCKET])

    # kernel path (card) vs plain path (the same weights on the CPU)
    obs = torch.from_numpy(frames[:BUCKET])
    taus = torch.rand((BUCKET, cfg.num_quantile_samples), generator=torch.Generator().manual_seed(SEED))
    net_before = engine.params
    with torch.inference_mode():
        k_out = net_before(obs.cuda(), cfg.num_quantile_samples, taus=taus.cuda())
        cpu_net = load_network(cfg, actions_n, params, torch.device("cpu"), use_noise=False)
        p_out = cpu_net(obs, cfg.num_quantile_samples, taus=taus)
    max_abs = (k_out.quantiles.cpu() - p_out.quantiles).abs().max().item()
    q_err = (k_out.q.cpu() - p_out.q).abs().max().item()
    top2 = torch.sort(p_out.q, dim=-1).values[:, -2:]
    # where both q vectors are within PATH_Q_TOL, a gap above twice that
    # leaves only one possible argmax
    clear = (top2[:, 1] - top2[:, 0]) > 2 * PATH_Q_TOL
    same_actions = bool(torch.equal(k_out.action.cpu()[clear], p_out.action[clear]))
    emit({"phase": "serve_parity", "batch": BUCKET, "max_abs_err": max_abs, "tol": PATH_TOL,
          "q_max_abs_err": q_err, "q_tol": PATH_Q_TOL, "clear_rows": int(clear.sum()),
          "actions_agree": same_actions,
          "actions_equal_all_rows": bool(torch.equal(k_out.action.cpu(), p_out.action))})
    check(max_abs <= PATH_TOL, f"kernel path vs plain path: max abs {max_abs}")
    check(q_err <= PATH_Q_TOL, f"kernel path vs plain path: q max abs {q_err}")
    check(int(clear.sum()) > 0, "no row has a clear Q gap: the action check would be empty")
    check(same_actions, "greedy actions differ where the Q gap is clear")

    # noisy mode on the card: the kernel path against the plain path on the
    # CPU at the same taus and eps, then an engine that draws its own noise
    noisy_net = load_network(cfg, actions_n, params, engine.device, use_noise=True)
    cpu_noisy = load_network(cfg, actions_n, params, torch.device("cpu"), use_noise=True)
    noise = noisy_net.sample_noise(torch.Generator(device=engine.device).manual_seed(SEED))
    with torch.inference_mode():
        k_noisy = noisy_net(obs.cuda(), cfg.num_quantile_samples, taus=taus.cuda(), noise=noise)
        p_noisy = cpu_noisy(obs, cfg.num_quantile_samples, taus=taus,
                            noise={k: (a.cpu(), b.cpu()) for k, (a, b) in noise.items()})
    n_err = (k_noisy.quantiles.cpu() - p_noisy.quantiles).abs().max().item()
    nq_err = (k_noisy.q.cpu() - p_noisy.q).abs().max().item()
    noisy_engine = InferenceEngine(cfg, actions_n, params, mode="noisy")
    n_acts, n_qs = noisy_engine.infer(frames[:BUCKET])
    noisy_ok = bool(np.all((n_acts >= 0) & (n_acts < actions_n)) and np.all(np.isfinite(n_qs)))
    emit({"phase": "noisy", "batch": BUCKET, "max_abs_err": n_err, "tol": PATH_TOL,
          "q_max_abs_err": nq_err, "q_tol": PATH_Q_TOL,
          "differs_from_greedy": not torch.equal(k_noisy.q, k_out.q), "engine_ok": noisy_ok})
    check(n_err <= PATH_TOL and nq_err <= PATH_Q_TOL,
          f"noisy kernel path vs plain path: max abs {n_err}, q {nq_err}")
    check(not torch.equal(k_noisy.q, k_out.q), "noise changed nothing")
    check(noisy_ok, "the noisy engine gave an action out of range or a non-finite q")

    # hot swap: new weights, new version, new answers
    version = server.load_params(init_params(cfg, actions_n, seed=SEED + 1))
    check(version == 1, f"params_version {version} after the first swap")
    with torch.inference_mode():
        k_after = engine.params(obs.cuda(), cfg.num_quantile_samples, taus=taus.cuda())
    changed = not torch.equal(k_after.q, k_out.q)
    a, q = server.act_values(frames[0], timeout=120)
    check(changed and 0 <= a < actions_n and np.all(np.isfinite(q)), "hot swap did not take")

    # stop() drains what is queued
    futures = [server.submit(frames[r]) for r in range(BUCKET)]
    final = server.stop(drain=True)
    drained = all(f.done() for f in futures) and all(
        0 <= f.result(timeout=0)[0] < actions_n for f in futures)
    emit({"phase": "swap_and_stop", "params_version": version, "answers_changed": changed,
          "drained": drained, "total_requests": final.get("total_requests")})
    check(drained, "stop() did not drain the queue")
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "rainbow_iqn_apex_tpu_torch")):
        print("chip_smoke: the port (rainbow_iqn_apex_tpu_torch/) is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from rainbow_iqn_apex_tpu_torch.config import Config
        from rainbow_iqn_apex_tpu_torch.kernels import (
            build,
            dueling_head,
            noisy_linear,
            quantile_huber,
            tau_embed,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2

    t_script = time.perf_counter()
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # deterministic cuDNN algorithms: the port's kernels use no atomics,
        # so a rerun of the `train` phase on the same card repeats its result
        torch.backends.cudnn.deterministic = True
        smi = nvidia_smi_line()
        emit({"phase": "device", "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
              "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
              "cudnn_deterministic": torch.backends.cudnn.deterministic})

        t0 = time.perf_counter()
        build.library()
        ptxas = [line.strip() for out in build.build_log for line in out.splitlines()
                 if "registers" in line or "spill" in line or "error" in line]
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "library": os.path.relpath(build.library_path(), ROOT), "ptxas": ptxas})

        results, counts = {}, {"serve": {}, "learn": {}}
        with open(os.path.join(ROOT, "configs", "serve_defaults.json")) as f:
            serve_cfg = Config.from_json(f.read())
        with open(os.path.join(ROOT, "configs", "reference_atari_defaults.json")) as f:
            learn_cfg = Config.from_json(f.read())
        results.update(phase_kernels(torch, serve_cfg))
        counts["serve"] = phase_serve(torch, serve_cfg)
        results.update(phase_kernels_learn(torch, learn_cfg))
        counts["learn"] = phase_learn(torch, learn_cfg)
        phase_learn_parity(torch, learn_cfg)
        phase_train(torch)
    except SmokeFailure as e:
        emit({"ok": False, "error": str(e)})
        return 1

    rows = {}
    for mod in (tau_embed, noisy_linear, dueling_head, quantile_huber):
        rows[mod.NAME] = (mod.SOURCE, mod.REPLACES)
        if hasattr(mod, "NAME_BWD"):
            rows[mod.NAME_BWD] = (mod.SOURCE_BWD, mod.REPLACES_BWD)
    line = []
    for name, res in results.items():
        by_path = {path: c.get(name, 0) for path, c in counts.items()}
        line.append({"name": name, "route": "cuda", "source": rows[name][0],
                     "replaces": rows[name][1], "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                     "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"], "library_ms": res["library_ms"]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_script})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
