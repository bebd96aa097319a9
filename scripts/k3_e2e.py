#!/usr/bin/env python3
"""End-to-end phases of one checkout's ``chip_smoke.py``, and the host time of
each K3 / K3-bwd and K2 / K2-bwd wrapper call inside the learn step and the
serving dispatch.

Runs the ``learn``, ``anakin``, ``apex`` and ``anakin_fused`` phases (or,
with ``--phases``, those named, ``learn_r2d2``, ``anakin_r2d2``, ``serve``,
``serve_quant``, ``kernels_learn``, ``kernels_replay``, ``kernels_frontier``,
``kernels_r2d2``, ``kernels_r2d2_anakin``, ``apex_mt`` and ``apex_quant``
among them; ``apex_quant``
runs over the filled replay of the ``apex`` phase, which runs first if the
list does not name it earlier) of the ``chip_smoke.py`` at ``--root`` on that checkout's
port, as the whole script runs them, so that two trees (say the parent commit unpacked with ``git
archive`` into the ignored ``_compare/``) are compared on one card, run after
run, in the order parent, change, change, parent:

    python3 scripts/k3_e2e.py --root _compare/parent --label parent
    python3 scripts/k3_e2e.py --label change

Then it runs the ``learn`` and ``serve`` phases once more with a host timer
around ``noisy_linear``, ``noisy_linear_bwd``, ``tau_embed`` and
``tau_embed_bwd``: the wrappers' host time per call where the learner casts
its weights afresh on every step, so the operands' pointers change from call
to call.  ``--phases`` and
``--host-phases`` name other lists of phases (an empty string: none).
Each phase prints its own JSON line; the script adds one ``k3_host`` line per
timed phase (``fwd`` / ``bwd`` K3's, ``k2`` / ``k2_bwd`` K2's), a
``device_ops`` line per profile a phase takes (the device ops, kernels,
copies and fills, in its window; a step's for ``learn``'s profile of
``PROFILE_STEPS`` steps, a tick's for ``apex_mt``'s of ``MT_PROFILE_TICKS``,
on any tree) and a ``k3_e2e`` summary.  The phase ``learn_reuse``, this
script's own, is the ``learn`` phase's agent and replay at ``replay_ratio``
2: ``REUSE_STEPS`` timed calls of ``learn_batch`` (each a pass 1 and a reuse
pass, with its two log-prob forwards) after ``LEARN_WARMUP``, then a profile
of ``PROFILE_STEPS`` calls, whose ``device_ops`` line gives a call's ops.
The phase ``act_r2d2``, also this script's own, times the R2D2 Anakin
trainer's ``act_append`` tick through its entry points on either tree and
profiles a few ticks (a tick's device ops); ``learn_r2d2`` and
``anakin_r2d2`` give a step's ops (and ``anakin_r2d2``, on a tree whose
phase profiles its act ticks, a tick's first).  Needs a CUDA card: exits
with 2 where there is none.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E_PHASES = "learn,anakin,apex,anakin_fused"
HOST_PHASES = "learn,serve"
REUSE_STEPS = 100  # learn_reuse: timed learn_batch calls (two passes each)
ACT_WARMUP, ACT_TICKS, ACT_PROFILE = 20, 300, 10  # act_r2d2: ticks


def _summary(us):
    us = sorted(us)
    if not us:
        return {"calls": 0}
    return {"calls": len(us), "p50_us": us[len(us) // 2], "p90_us": us[int(0.9 * (len(us) - 1))],
            "mean_us": sum(us) / len(us)}


def learn_reuse(smoke, torch, cfg):
    """The ``learn`` phase's agent, replay, prefetcher and write-back ring at
    ``replay_ratio`` 2: REUSE_STEPS timed ``learn_batch`` calls after the
    warm-up, then a profile of PROFILE_STEPS calls (``smoke.device_rows``)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from rainbow_iqn_apex_tpu_torch.agents import Agent
    from rainbow_iqn_apex_tpu_torch.parallel.supervisor import TrainSupervisor
    from rainbow_iqn_apex_tpu_torch.train import priority_beta
    from rainbow_iqn_apex_tpu_torch.utils.prefetch import make_replay_prefetcher
    from rainbow_iqn_apex_tpu_torch.utils.writeback import RingCommitter, WritebackRing

    cfg = smoke._learn_cfg(cfg).replace(replay_ratio=2)
    memory = smoke._fill_replay(cfg, np)
    agent = Agent(cfg, 18, cfg.seed)
    sup = TrainSupervisor(cfg)
    ring = WritebackRing(cfg.writeback_depth)
    prefetcher = make_replay_prefetcher(memory, cfg, lambda: priority_beta(cfg, 0), agent.device)
    committer = RingCommitter(ring, prefetcher.update_priorities, sup, agent.load_snapshot)

    def calls(n):
        for _ in range(n):
            idx, batch = prefetcher.get()
            committer.commit(ring.push(agent.step, idx, agent.learn_batch(batch)))
        committer.drain()
        torch.cuda.synchronize()

    try:
        calls(smoke.LEARN_WARMUP)
        t = time.perf_counter()
        calls(REUSE_STEPS)
        elapsed = time.perf_counter() - t
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            calls(smoke.PROFILE_STEPS)
        ops = sum(r[2] for r in smoke.device_rows(torch, prof))
    finally:
        prefetcher.close()
    print(json.dumps({"phase": "learn_reuse", "replay_ratio": 2, "calls": REUSE_STEPS,
                      "learn_calls_per_s": REUSE_STEPS / elapsed,
                      "sgd_steps_per_s": 2 * REUSE_STEPS / elapsed,
                      "device_ops_per_call": ops / smoke.PROFILE_STEPS,
                      "rollbacks": sup.rollbacks}), flush=True)
    return None


def act_r2d2(smoke, torch, cfg):
    """The R2D2 Anakin trainer's ``act_append`` tick on this tree (any tree:
    it takes the trainer's entry points only), at the reference config's 16
    lanes, 84x84x4 and LSTM 512 over a 512-sequence ring: ACT_WARMUP ticks,
    ACT_TICKS timed ticks (host us a tick, each ending in the loop's read
    of the actions), then a profile of ACT_PROFILE ticks whose
    ``device_ops`` line gives a tick's device ops (kernels, copies, fills)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from rainbow_iqn_apex_tpu_torch.agents.agent import put_frames
    from rainbow_iqn_apex_tpu_torch.ops.r2d2 import init_r2d2_state
    from rainbow_iqn_apex_tpu_torch.replay.device_sequence import DeviceSequenceReplay
    from rainbow_iqn_apex_tpu_torch.train_anakin_r2d2 import _seq_geometry, build_act_append

    cfg = smoke._r2d2_anakin_cfg(cfg)
    lanes, lstm = cfg.num_envs_per_actor, cfg.lstm_size
    frame = (cfg.frame_height, cfg.frame_width)
    seq, stride, _, _ = _seq_geometry(cfg)
    dev = torch.device("cuda", 0)
    replay = DeviceSequenceReplay(512, seq, frame, lstm, lanes, stride, cfg.priority_exponent,
                                  cfg.priority_eps, device=dev)
    ss = replay.init_state()
    ts = init_r2d2_state(cfg, 18, cfg.seed, frame, device=dev)
    act_append = build_act_append(cfg, 18, replay,
                                  torch.Generator(device=dev).manual_seed(cfg.seed))
    rng = np.random.default_rng(7)
    pool = rng.integers(0, 256, (16, lanes, *frame), dtype=np.uint8)
    stack = torch.zeros((lanes, *frame, cfg.history_length), dtype=torch.uint8, device=dev)
    carry = {"state": (torch.zeros((lanes, lstm), device=dev),
                       torch.zeros((lanes, lstm), device=dev)),
             "prev": None, "cuts": np.zeros(lanes, bool), "tick": 0}

    def tick():
        frame_d = put_frames(pool[carry["tick"] % len(pool)], dev)
        keep_d = put_frames((~carry["cuts"]).astype(np.uint8), dev)
        actions_d, carry["state"], pre = act_append(ts.net, stack, ss, carry["state"], frame_d,
                                                    keep_d, carry["prev"])
        actions_d.cpu()  # the loop's one read
        terms = rng.random(lanes) < smoke.SEQ_P_TERM
        carry["prev"] = (frame_d, actions_d, rng.normal(size=lanes).astype(np.float32), terms,
                         np.zeros(lanes, bool), pre[0], pre[1])
        carry["cuts"] = terms
        carry["tick"] += 1

    for _ in range(ACT_WARMUP):
        tick()
    us = []
    for _ in range(ACT_TICKS):
        t = time.perf_counter()
        tick()
        us.append((time.perf_counter() - t) * 1e6)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ACT_PROFILE):
            tick()
        torch.cuda.synchronize()
    rows = smoke.device_rows(torch, prof)
    print(json.dumps({"phase": "act_r2d2", "ticks": ACT_TICKS, "act_append_us": _summary(us),
                      "device_ops_per_tick": sum(r[2] for r in rows) / ACT_PROFILE,
                      "device_us_per_tick": sum(r[1] for r in rows) / ACT_PROFILE,
                      "ops": sorted(([k[:60], c / ACT_PROFILE] for k, _, c in rows),
                                    key=lambda r: -r[1])}), flush=True)
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="change")
    ap.add_argument("--phases", default=E2E_PHASES)
    ap.add_argument("--host-phases", default=HOST_PHASES)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k3_e2e: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as smoke
    from rainbow_iqn_apex_tpu_torch.config import Config
    from rainbow_iqn_apex_tpu_torch.kernels import build
    from rainbow_iqn_apex_tpu_torch.kernels import noisy_linear as nl
    from rainbow_iqn_apex_tpu_torch.kernels import tau_embed as te
    from rainbow_iqn_apex_tpu_torch.models import layers

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    cfgs = {}
    for name in ("serve_defaults", "reference_atari_defaults"):
        with open(os.path.join(root, "configs", name + ".json")) as f:
            cfgs[name] = Config.from_json(f.read())
    phases = {"learn": (smoke.phase_learn, "reference_atari_defaults"),
              "anakin": (smoke.phase_anakin, "reference_atari_defaults"),
              "apex": (smoke.phase_apex, "reference_atari_defaults"),
              "anakin_fused": (smoke.phase_anakin_fused, "reference_atari_defaults"),
              "learn_r2d2": (smoke.phase_learn_r2d2, "reference_atari_defaults"),
              "anakin_r2d2": (smoke.phase_anakin_r2d2, "reference_atari_defaults"),
              "serve": (smoke.phase_serve, "serve_defaults"),
              "serve_quant": (smoke.phase_serve_quant, "serve_defaults"),
              "apex_quant": (smoke.phase_apex_quant, "reference_atari_defaults"),
              "apex_mt": (smoke.phase_apex_mt, "reference_atari_defaults"),
              "kernels_learn": (smoke.phase_kernels_learn, "reference_atari_defaults"),
              "kernels_replay": (smoke.phase_kernels_replay, "reference_atari_defaults"),
              "kernels_frontier": (smoke.phase_kernels_frontier, "reference_atari_defaults"),
              "kernels_r2d2": (smoke.phase_kernels_r2d2, "reference_atari_defaults"),
              "kernels_r2d2_anakin": (smoke.phase_kernels_r2d2_anakin,
                                      "reference_atari_defaults"),
              "act_r2d2": (lambda torch_, cfg: act_r2d2(smoke, torch_, cfg),
                           "reference_atari_defaults"),
              "learn_reuse": (lambda torch_, cfg: learn_reuse(smoke, torch_, cfg),
                              "reference_atari_defaults")}
    apex_ctx = []  # the apex phase's filled replay, which apex_quant runs over
    device_rows = smoke.device_rows

    def counted_rows(torch_, prof):  # the device ops of each profile the phases take
        rows = device_rows(torch_, prof)
        ops = sum(r[2] for r in rows)
        per = {"learn": smoke.PROFILE_STEPS, "learn_reuse": smoke.PROFILE_STEPS,
               "apex_mt": smoke.MT_PROFILE_TICKS, "learn_r2d2": smoke.R2D2_PROFILE_STEPS,
               "act_r2d2": ACT_PROFILE}.get(current[0])
        if current[0] == "anakin_r2d2":  # the tick profile (this tree's), then the steps'
            per = smoke.ANAKIN_R2D2_PROFILE_STEPS
            if getattr(smoke, "ACT_PROFILE_TICKS", None) and not seen_act[0]:
                per, seen_act[0] = smoke.ACT_PROFILE_TICKS, True
        print(json.dumps({"phase": "device_ops", "label": args.label, "of": current[0],
                          "ops": ops, "ops_per_step": ops / per if per else None}), flush=True)
        return rows

    smoke.device_rows = counted_rows
    current = [None]
    seen_act = [False]

    def run(name):
        fn, cfg = phases[name]
        extra = ()
        if name == "apex_quant":
            if not apex_ctx:
                seconds["apex"] = run("apex")
            extra = (apex_ctx.pop(),)
        t = time.perf_counter()
        current[0] = name
        out = fn(torch, cfgs[cfg], *extra)
        elapsed = time.perf_counter() - t
        if name == "apex":
            apex_ctx[:] = [out[1]]
        del out, extra
        gc.collect()
        torch.cuda.empty_cache()
        return elapsed

    seconds = {}
    for name in filter(None, args.phases.split(",")):
        seconds[name] = run(name)
    apex_ctx.clear()

    calls = {"fwd": [], "bwd": [], "k2": [], "k2_bwd": []}
    fwd, bwd = nl.noisy_linear, nl.noisy_linear_bwd
    k2, k2_bwd = te.tau_embed, te.tau_embed_bwd

    def timed(kind, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            calls[kind].append((time.perf_counter() - t) * 1e6)
            return out
        return wrapper

    nl.noisy_linear = layers.noisy_linear = timed("fwd", fwd)
    nl.noisy_linear_bwd = timed("bwd", bwd)
    te.tau_embed = layers.tau_embed = timed("k2", k2)
    te.tau_embed_bwd = timed("k2_bwd", k2_bwd)
    try:
        for name in filter(None, args.host_phases.split(",")):
            for us in calls.values():
                us.clear()
            run(name)
            print(json.dumps({"phase": "k3_host", "label": args.label, "of": name,
                              **{kind: _summary(us) for kind, us in calls.items()}}),
                  flush=True)
    finally:
        nl.noisy_linear = layers.noisy_linear = fwd
        nl.noisy_linear_bwd = bwd
        te.tau_embed = layers.tau_embed = k2
        te.tau_embed_bwd = k2_bwd
    print(json.dumps({"phase": "k3_e2e", "label": args.label, "root": args.root,
                      "device": torch.cuda.get_device_name(0), "build_s": build_s,
                      "seconds_by_phase": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
