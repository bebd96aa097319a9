#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (rainbow_iqn_apex_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``rainbow_iqn_apex_tpu_torch/csrc``,
holds each one against its plain PyTorch twin at the full-width shapes the
serving path gives it (bucket 64, K = 32 taus, F = 3136, hidden 512,
18 actions, bf16), times kernel, twin and the nearest single PyTorch call,
then drives the port's ``PolicyServer`` from ``configs/serve_defaults.json``
with seeded random weights: 512 requests from 8 client threads, launch
counters that prove the path went through every kernel, the kernel path
against the plain path on one fixed batch, a weight hot-swap and a draining
stop.  One JSON object per line; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
that line.  Without a CUDA device, or without the port beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
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
    # device-side events only (kernels, copies): CPU-side ops carry the same
    # device time again and would count it twice
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
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
    for name, n in counts.items():
        check(n > 0, f"{name} was never launched on the main path")
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
        from rainbow_iqn_apex_tpu_torch.kernels import build, dueling_head, noisy_linear, tau_embed
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2

    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = nvidia_smi_line()
        emit({"phase": "device", "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
              "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

        t0 = time.perf_counter()
        build.library()
        ptxas = [line.strip() for out in build.build_log for line in out.splitlines()
                 if "registers" in line or "spill" in line or "error" in line]
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "library": os.path.relpath(build.library_path(), ROOT), "ptxas": ptxas})

        with open(os.path.join(ROOT, "configs", "serve_defaults.json")) as f:
            cfg = Config.from_json(f.read())
        results = phase_kernels(torch, cfg)
        counts = phase_serve(torch, cfg)
    except SmokeFailure as e:
        emit({"ok": False, "error": str(e)})
        return 1

    modules = {m.NAME: m for m in (tau_embed, noisy_linear, dueling_head)}
    line = []
    for name, res in results.items():
        mod = modules[name]
        line.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                     "replaces": mod.REPLACES, "launches": counts[name],
                     "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                     "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"], "library_ms": res["library_ms"]})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
