#!/usr/bin/env python3
"""Per-shape times of K3 (the NoisyLinear GEMM), K3-bwd, K2 (the cosine-tau
embedding merged with phi), K2-bwd, K9 (R2D2's LSTM recurrence), K9-bwd,
K10g (the weight-only int8 / e4m3 NoisyLinear GEMM), K5 (the PER draw) and
K5f (the frontier's draw with IS weights), K4 (the dueling head, in every
mode), K12 (the device games' tick), and K1 (the quantile-Huber loss) and
K4-bwd with the learn step's loss chain on the card, K2's multi-game modes
K2g and K2g-bwd included, K7 and K8 (the device replay's append and
n-step assembly), and K6 and K6f (the fenced priority write-backs) with the
launches they fold into.

Times the port's ``noisy_linear`` and ``noisy_linear_bwd`` at every shape the
main paths give them (bucket 64's layers and ``chip_smoke.py``'s
``K3_EXTRA_SHAPES``: M 2048 / 1024 / 512 over F 3136 and the jaxgame F 2304,
the 512 -> 1 and 512 -> 18 out layers, the R2D2 head 512 -> 512 over B x T =
32 x 80 rows and at a 16-lane tick), and ``tau_embed`` and ``tau_embed_bwd``
at theirs (the learner's [B 32 x N 64, F 3136], the online pass at s' [32 x
32] and serving's bucket 64 [64 x 32], the act tick [16 x 32], the jaxgame
trunk's F 2304 at [32 x 64] and [16 x 32], the multi-game path's K2g /
K2g-bwd at [32 x 64, F 2304] and serving's at [64 x 32, F 3136] over four
games, and num_cosines 8), and ``lstm_forward`` / ``lstm_backward`` at the
R2D2 learner's [B 32, T, LSTM 512] (the burn-in T 40, the train slice T 80,
the whole sequence T 120; the backward over T 80) and the act tick [16, 1,
512], beside the plain twin and cuDNN's LSTM layer over phi [B, T, 3136]
(``chip_smoke.py``'s yardstick: it does the input product too, which the
port leaves to one matmul), ``noisy_linear_q`` at ``chip_smoke.py``'s
``kernels_quant`` layers (value_hidden [M, 3136 -> 512], advantage_out
[M, 512 -> 18], value_out [M, 512 -> 1]; greedy at serving's M 2048, noisy
at the act tick's M 512; int8 and e4m3 weights), ``replay_draw`` at
[1,000,000 slots, G 1 and 4, B 32] and ``frontier_draw`` at [1,000,000, G
8, B 32] (half the mirror dead, as one live shard of two), each beside its
plain twin's error, with ``chip_smoke.py``'s timers (and, for K3, the host
time of one wrapper call), and K10g, K5 and K5f with the plain twin's time,
``chip_smoke.py``'s library yardstick (K10g greedy: the dequantize into bf16
then ``F.linear``; K5: ``cumsum`` + ``searchsorted``; K5f: those, the gather,
``pow`` and ``amax``) and the bound.  K4 (``--only k4``): greedy at bucket
64 [64, 32, 18] and at R2D2's one tau a row [2560, 1, 18], the gather at the
learner's [32, 64, 18], K4m at the multi-game path's [32, 32, 5] over four
games and serving's [64, 32, 18], K4l there masked and not, and a learn
step's heads (B 32, K 32, N' 64, N 64, A 18; and the multi-game path's A 5,
masked): ``ms`` the tree's own route (one heads-mode launch where the tree
has ``dueling_learn``, else the three launches and td_target's two
elementwise ops it replaces), ``three_launch_ms`` the latter on every tree.
K12 (``--only k12``): every game's auto-reset tick at 16 and 4,096 lanes and
the host adapter's one-lane step (timed as the adapter's reset and a step,
beside the reset alone: a reset-free step run on and on walks catch's ball
off its grid), each beside its byte bound.  K1 (``--only k1``): the learn step's loss chain at
B 32, N = N' = 64, A 18: K1 per-sample and weighted, K4-bwd in its dz and
loss modes, and the chain from the heads launch to K3-bwd (K1, the weighted mean, the
seed, the mean's and product's backward, the scale by K1's gradient, K4-bwd)
in pass 1 and a reuse pass: ``ms`` the tree's route (three launches where
the tree has K1's weighted mode), ``parent_route_ms`` the eight (nine) ops
of the parent's on every tree.  K7 (``--only k7``): the append tick of 16
lanes of 84 x 84 (host-fed Anakin) and 80 x 80 (the fused Anakin's jaxgame
frames) on ``chip_smoke.py``'s warm 64-slot ring.  K8 (``--only k8``): the
learn batch [32, 84, 84, 4] and [32, 80, 80, 4], G 1 and 4, n 3, on that
warm ring and on a cold one of 2,048 slots a lane (>= 200 MB of frames)
whose calls cycle through 80 id sets spread over it, so L2 cannot hold
them; each beside its byte bound, counted as ``chip_smoke.py`` counts it.
K6 (``--only k6``): the fused Anakin step's loss and write-back at B 32, N =
N' = 64 over the reference config's 1,000,000 priorities, G 1 and 4: ``ms``
the tree's route (K1's weighted launch with K6 folded in, where the tree
has the fold), ``two_launch_ms`` the parent's K1 launch then K6's on every
tree, and each alone.  K6f (``--only k6f``): the apex loop's mirror updates
between two draws (8 write-back batches of 32, two ticks of 16 staged rows)
and the draw (1,000,000 slots, G 8, B 32): ``ms`` the tree's route (K5f
applying the queue, where the tree has it), ``parent_route_ms`` a K6f launch
a batch, an ``index_copy_`` a staged tick and K5f on every tree, and K5f
alone, K6f's one batch and (with the queue) its apply of the whole queue.
K11 (``--only k11``): the R2D2 learner's TD epilogue at [32, 80, 18] and G
4's [128, 80, 18], alone, as the learn step runs it (strided slices, or
three copies first) and with the write-back (K6s folded in, or K11 then
K6s), and K11 then K6s on every tree.  K7s (``--only k7s``): the R2D2 act
tick's work before the act on a quiet tick and an all-emitting one: the
tree's route (one prologue launch, or seven device ops), K7s's append alone
and the seven-op route on every tree.
The port is imported from ``--root`` (default: this checkout), so two trees,
e.g. a parent commit unpacked into an ignored directory, are compared on one
card by running the script once per tree in one call:

    python3 scripts/bench_kernels.py --label change
    python3 scripts/bench_kernels.py --root parent --label parent

A tree whose K2-bwd recomputes the cos features (no ``save_cos``) is called
that way; a shape a tree refuses is reported as refused.  Prints one JSON
object per (kernel, shape, mode); ``--out`` appends them to a file as well;
``--only fwd`` (or ``bwd``, ``k2``, ``k2bwd``, ``k9``, ``k9bwd``, ``k10g``,
``k5``, ``k5f``, ``k4``, ``k12``, ``k1``, ``k7``, ``k8``, ``k6``, ``k6f``, ``k11``,
``k7s``, or layer names)
times a subset.  K9's unrolls (T > 1) are timed as eager calls
between CUDA events, their device time being far above the launch's (a
parent tree's cooperative launch is not captured in a CUDA graph); the act
tick is timed that way and, where the tree's K9 has launch plans (a plain
launch at T 1), in a CUDA graph as well (``graph_ms``).  Needs a CUDA card:
it exits with 2 where there is none.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 30  # CUDA-graph replays per time (median reported)

# (layer, M, K, N, relu): bucket 64's layers, then chip_smoke.py's other
# main-path shapes; K3-bwd runs on the learner's online pass, always noisy
FWD_SHAPES = [("hidden", 2048, 3136, 512, True), ("value_out", 2048, 512, 1, False),
              ("advantage_out", 2048, 512, 18, False)]
# (name, B, N, F, C, games): games 0 is K2 / K2-bwd
K2_FWD = [("learner", 32, 64, 3136, 64, 0), ("s_prime", 32, 32, 3136, 64, 0),
          ("bucket64", 64, 32, 3136, 64, 0), ("act_tick", 16, 32, 3136, 64, 0),
          ("jaxgame", 32, 64, 2304, 64, 0), ("jaxgame_tick", 16, 32, 2304, 64, 0),
          ("learner_c8", 32, 64, 3136, 8, 0), ("mt_path", 32, 64, 2304, 64, 4),
          ("mt_serving", 64, 32, 3136, 64, 4)]
K2_BWD = [("learner", 32, 64, 3136, 64, 0), ("jaxgame", 32, 64, 2304, 64, 0),
          ("learner_c8", 32, 64, 3136, 8, 0), ("mt_path", 32, 64, 2304, 64, 4),
          ("mt_serving", 64, 32, 3136, 64, 4)]
# (name, B, T, saves for a backward): K9 at the R2D2 learner's and actor's shapes
K9_FWD = [("burn_in", 32, 40, False), ("train", 32, 80, True), ("sequence", 32, 120, True),
          ("act_tick", 16, 1, False)]
K9_BWD = [("train", 32, 80)]
K9_HIDDEN, K9_FEATURES = 512, 3136  # the reference config's LSTM and trunk widths
# K10g at chip_smoke.py's kernels_quant shapes: (M, noisy) rows, (layer, K, N, relu)
K10G_ROWS = [(2048, False), (512, True)]
K10G_SWEEP_ROWS = [(2048, False), (2048, True), (512, False), (512, True)]  # --k10g-splits
K10G_LAYERS = [("value_hidden", 3136, 512, True), ("advantage_out", 512, 18, False),
               ("value_out", 512, 1, False)]
K5_SLOTS, K5_BATCH = 1_000_000, 32  # the reference config's replay and learner batch
# K7 / K8: the reference config's 16 lanes, history 4, n_step 3; chip_smoke.py's
# 64-slot ring (warm), and 2,048 slots a lane (231 / 210 MB of 84 x 84 / 80 x 80
# frames, past the 50 MB L2) whose draws cycle through COLD_SETS id sets,
# COLD_BURST calls a timed call (80 calls a graph replay: 128 MB of frames read
# at B 32 before a set comes round again)
REPLAY_LANES, REPLAY_H, REPLAY_N = 16, 4, 3
WARM_SEG, COLD_SEG = 64, 2048
COLD_SETS, COLD_BURST = 80, 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--k10g-splits", default=None,
                    help="comma-separated k splits to time K10g's wide layers at, in place of "
                         "forward_plan's (a tree whose K10g has forward_plan(m, n, k, noisy, clusters))")
    ap.add_argument("--only", default=None,
                    help="comma-separated kernels (fwd, bwd, k2, k2bwd, k9, k9bwd, k10g, k5, k5f, "
                         "k4, k12, k1, k7, k8, k6, k6f, k11, k7s) or layer names to time; "
                         "default all")
    args = ap.parse_args()
    only = set(args.only.split(",")) if args.only else None

    def wanted(kind, name):
        return only is None or kind in only or name in only
    import torch

    if not torch.cuda.is_available():
        print("bench_kernels: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import (
        BF16_FLOPS,
        FP32_FLOPS,
        GAME_NAMES,
        K1_OPS_PER_PAIR,
        K3_EXTRA_SHAPES,
        K3_TOL,
        R2D2_RESET_P,
        _game_bytes,
        _lstm_args,
        _mt_mask,
        _replay_ticks,
        bound_ms,
        errors,
        host_us,
        time_ms,
    )

    shapes = FWD_SHAPES + list(K3_EXTRA_SHAPES)
    sys.path.insert(0, os.path.abspath(args.root))
    from rainbow_iqn_apex_tpu_torch.kernels import build
    from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear import (
        noisy_linear,
        noisy_linear_bwd,
        noisy_linear_bwd_plain,
        noisy_linear_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels import lstm as lstm_module
    from rainbow_iqn_apex_tpu_torch.kernels.lstm import (
        lstm_backward,
        lstm_backward_plain,
        lstm_forward,
        lstm_forward_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.tau_embed import (
        tau_embed,
        tau_embed_bwd,
        tau_embed_bwd_plain,
        tau_embed_plain,
    )
    from rainbow_iqn_apex_tpu_torch.models.layers import _f

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bf = torch.bfloat16
    build.library()

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def layer(m, k, n):
        x = randn(m, k).relu().to(bf) if k <= 512 else randn(m, k, dtype=bf)
        return dict(x=x, w_mu=randn(n, k, scale=k ** -0.5, dtype=bf), b_mu=randn(n, scale=0.1),
                    w_sigma=(randn(n, k).abs() * 0.5 * k ** -0.5).to(bf),
                    b_sigma=randn(n).abs() * 0.5 * k ** -0.5, f_in=_f(randn(k)), f_out=_f(randn(n)))

    def emit(row):
        row = {"label": args.label, "device": torch.cuda.get_device_name(0), **row}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for name, m, k, n, relu in shapes:
        if not wanted("fwd", name):
            continue
        p = layer(m, k, n)
        for noisy in (False, True):
            a = [p["x"], p["w_mu"], p["b_mu"]]
            if noisy:
                a += [p["w_sigma"], p["b_sigma"], p["f_in"], p["f_out"]]
            err = (noisy_linear(*a, relu=relu) - noisy_linear_plain(*a, relu=relu)).abs().max()
            emit({"kernel": "K3_noisy_linear", "layer": name, "shape": [m, k, n], "noisy": noisy,
                  "relu": relu, "max_abs_err": float(err),
                  "ms": time_ms(torch, lambda: noisy_linear(*a, relu=relu), reps=REPS),
                  "host_us": host_us(torch, lambda: noisy_linear(*a, relu=relu))})
    for name, m, k, n, relu in shapes:
        if m < 512 or not wanted("bwd", name):
            continue
        p = layer(m, k, n)
        g = randn(m, n)
        y = noisy_linear_plain(p["x"], p["w_mu"], p["b_mu"], p["w_sigma"], p["b_sigma"],
                               p["f_in"], p["f_out"], relu=True) if relu else None
        a = (g, y, p["x"], p["w_mu"], p["w_sigma"], p["f_in"], p["f_out"])
        got, want = noisy_linear_bwd(*a), noisy_linear_bwd_plain(*a)
        err = max(float((u.float() - v.float()).abs().max()) for u, v in zip(got, want))
        emit({"kernel": "K3_noisy_linear_bwd", "layer": name, "shape": [m, k, n], "noisy": True,
              "relu": relu, "max_abs_err": err,
              "ms": time_ms(torch, lambda: noisy_linear_bwd(*a), reps=REPS),
              "host_us": host_us(torch, lambda: noisy_linear_bwd(*a))})

    saves_cos = "save_cos" in inspect.signature(tau_embed).parameters

    def k2_inputs(batch, n, feat, cos_n, games):
        taus = torch.rand((batch, n), generator=gen, device=dev)
        w_e = randn(feat, cos_n, scale=cos_n ** -0.5, dtype=bf)
        phi = randn(batch, feat).relu().to(bf)
        extra = ()
        if games:
            game = (torch.arange(batch, device=dev, dtype=torch.int32) % games).contiguous()
            extra = (game, randn(games, feat, scale=0.3))
        return (taus, w_e, randn(feat, scale=0.1), phi), extra

    for name, batch, n, feat, cos_n, games in K2_FWD:
        if not wanted("k2", name):
            continue
        a, extra = k2_inputs(batch, n, feat, cos_n, games)
        row = {"kernel": "K2g_tau_embed_game" if games else "K2_tau_embed", "at": name,
               "shape": [batch * n, feat, cos_n, games]}
        try:
            err = (tau_embed(*a, *extra).float() - tau_embed_plain(*a, *extra).float()).abs().max()
        except ValueError as e:
            emit({**row, "refused": str(e)})
            continue
        emit({**row, "max_abs_err": float(err),
              "ms": time_ms(torch, lambda: tau_embed(*a, *extra), reps=REPS)})
    for name, batch, n, feat, cos_n, games in K2_BWD:
        if not wanted("k2bwd", name):
            continue
        a, extra = k2_inputs(batch, n, feat, cos_n, games)
        dh = randn(batch * n, feat, dtype=bf)
        row = {"kernel": "K2g_tau_embed_game_bwd" if games else "K2_tau_embed_bwd", "at": name,
               "shape": [batch * n, feat, cos_n, games]}
        try:
            kw = {"cos_t": tau_embed(*a, *extra, save_cos=True)[1]} if saves_cos else {}
            got = tau_embed_bwd(*a, dh, *extra, **kw)
        except ValueError as e:
            emit({**row, "refused": str(e)})
            continue
        want = tau_embed_bwd_plain(*a, dh, *extra)
        err = max(float((u.float() - v.float()).abs().max()) for u, v in zip(got, want))
        emit({**row, "max_abs_err": err,
              "ms": time_ms(torch, lambda: tau_embed_bwd(*a, dh, *extra, **kw), reps=REPS)})

    def cudnn_ms(batch, steps, backward):
        """cuDNN's LSTM layer at [batch, steps, K9_HIDDEN] over phi [batch,
        steps, K9_FEATURES], forward or its backward (input and weight
        gradients), timed as eager calls."""
        lstm = torch.nn.LSTM(K9_FEATURES, K9_HIDDEN, batch_first=True).to(dev)
        phi = randn(batch, steps, K9_FEATURES).requires_grad_(backward)
        if not backward:
            with torch.no_grad():
                return time_ms(torch, lambda: lstm(phi), graph=False, reps=REPS)
        out, _ = lstm(phi)
        g_out = randn(*out.shape)
        wrt = [phi, *lstm.parameters()]
        return time_ms(torch, lambda: torch.autograd.grad(out, wrt, g_out, retain_graph=True),
                       graph=False, reps=REPS)

    k9_tol = dict(atol=1e-4, rtol=1e-4)
    for name, batch, steps, save in K9_FWD:
        if not wanted("k9", name):
            continue
        a = _lstm_args(torch, gen, batch, steps, K9_HIDDEN, R2D2_RESET_P)
        got, want = lstm_forward(*a, save=save), lstm_forward_plain(*a, save=save)
        pairs = list(zip(got[:3], want[:3])) + (list(zip(got[3], want[3])) if save else [])
        err = max(errors(torch, u, v, k9_tol)[0] for u, v in pairs)
        row = {"kernel": "K9_lstm", "at": name, "shape": [batch, steps, K9_HIDDEN],
               "saves_for_backward": save, "max_abs_err": err,
               "ms": time_ms(torch, lambda: lstm_forward(*a, save=save), graph=False, reps=REPS),
               "plain_ms": time_ms(torch, lambda: lstm_forward_plain(*a, save=save), reps=REPS),
               "cudnn_ms": cudnn_ms(batch, steps, False)}
        if steps == 1 and hasattr(lstm_module, "forward_plan"):  # a plain launch at T 1
            row["graph_ms"] = time_ms(torch, lambda: lstm_forward(*a, save=save), reps=REPS)
        emit(row)
    for name, batch, steps in K9_BWD:
        if not wanted("k9bwd", name):
            continue
        xw, w_h, b_h, reset, c0, h0 = _lstm_args(torch, gen, batch, steps, K9_HIDDEN,
                                                 R2D2_RESET_P)
        _, _, _, (gates, c_seq) = lstm_forward_plain(xw, w_h, b_h, reset, c0, h0, save=True)
        a = (randn(batch, steps, K9_HIDDEN), None, None, w_h, reset, gates, c_seq, c0)
        err = errors(torch, lstm_backward(*a), lstm_backward_plain(*a), k9_tol)[0]
        emit({"kernel": "K9_lstm_bwd", "at": name, "shape": [batch, steps, K9_HIDDEN],
              "max_abs_err": err,
              "ms": time_ms(torch, lambda: lstm_backward(*a), graph=False, reps=REPS),
              "plain_ms": time_ms(torch, lambda: lstm_backward_plain(*a), reps=REPS),
              "cudnn_ms": cudnn_ms(batch, steps, True)})

    if wanted("k10g", None):
        from rainbow_iqn_apex_tpu_torch.kernels.dequantize import dequantize_plain
        from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear_q import (
            noisy_linear_q,
            noisy_linear_q_plain,
        )
        from rainbow_iqn_apex_tpu_torch.kernels.quantize import quantize_plain

        import rainbow_iqn_apex_tpu_torch.kernels.noisy_linear_q as k10g_module

        planned = getattr(k10g_module, "forward_plan", None)
        sweep = [int(s) for s in args.k10g_splits.split(",")] if args.k10g_splits else [None]
        for mode, split in ((mode, split) for mode in ("int8", "fp8") for split in sweep):
            if split is not None:  # every wide layer at this split
                k10g_module.forward_plan = lambda m, n, k, noisy, clusters, s=split: planned(
                    m, n, k, noisy, clusters) and min(s, -(-k // 128))
            for m, noisy in K10G_ROWS if split is None else K10G_SWEEP_ROWS:
                for name, k, n, relu in K10G_LAYERS:
                    if split is not None and n <= 32:
                        continue
                    w = layer(m, k, n)
                    x = randn(m, k).relu().to(bf)
                    rows = n if mode == "int8" else 1
                    q = {key: quantize_plain(w[key].float(), mode, rows if w[key].dim() == 2 else 1)
                         for key in ("w_mu", "b_mu", "w_sigma", "b_sigma")}
                    a = [x, *q["w_mu"], *q["b_mu"]]
                    if noisy:
                        a += [*q["w_sigma"], *q["b_sigma"], w["f_in"], w["f_out"]]
                    err, _, _ = errors(torch, noisy_linear_q(*a, relu=relu),
                                       noisy_linear_q_plain(*a, relu=relu), K3_TOL)
                    products = 2 if noisy else 1
                    nbytes = (m * k * 2 + products * (n * k + n + 4 * q["w_mu"][1].numel() + 4)
                              + m * n * 4 + (4 * (k + n) if noisy else 0))
                    bms, by = bound_ms(nbytes, products * 2 * m * n * k, BF16_FLOPS)
                    lib_ms = None
                    if not noisy:  # chip_smoke.py's two calls: the dequantize, then F.linear
                        q_w, s_w = q["w_mu"][0], q["w_mu"][1].view(-1, 1)
                        b_bf = dequantize_plain(*q["b_mu"], bf)
                        w_buf = torch.empty((n, k), dtype=bf, device=dev)

                        def lib():
                            if mode == "int8":
                                torch.mul(q_w, s_w, out=w_buf)
                                return torch.nn.functional.linear(x, w_buf, b_bf)
                            return torch.nn.functional.linear(x, q_w.to(bf), b_bf)
                        lib_ms = time_ms(torch, lib, reps=REPS)
                    emit({"kernel": "K10g_noisy_linear_q", "layer": name, "mode": mode,
                          "shape": [m, k, n], "noisy": noisy, "relu": relu, "max_abs_err": err,
                          "splits": split if split is not None else planned(
                              m, n, k, noisy, k10g_module.max_clusters(dev.index or 0, noisy))
                          if hasattr(k10g_module, "max_clusters") else None,
                          "ms": time_ms(torch, lambda: noisy_linear_q(*a, relu=relu), reps=REPS),
                          "plain_ms": time_ms(torch, lambda: noisy_linear_q_plain(*a, relu=relu),
                                              reps=REPS),
                          "library_ms": lib_ms, "bound_ms": bms, "bound_by": by})
        if planned is not None:
            k10g_module.forward_plan = planned

    if wanted("k5", None):
        from rainbow_iqn_apex_tpu_torch.kernels.replay_draw import replay_draw, replay_draw_plain

        p = torch.rand((K5_SLOTS,), generator=gen, device=dev)
        p[torch.rand((K5_SLOTS,), generator=gen, device=dev) < 0.3] = 0.0
        for groups in (1, 4):
            u = torch.rand((groups, K5_BATCH), generator=gen, device=dev)
            idx, total = replay_draw(p, u)
            twin, _ = replay_draw_plain(p, u)
            kb = torch.arange(K5_BATCH, device=dev, dtype=torch.float32)
            u_abs = (kb + u) / K5_BATCH * total
            bms, by = bound_ms(K5_SLOTS * 4 + 2 * groups * K5_BATCH * 4 + 4, K5_SLOTS, FP32_FLOPS)
            emit({"kernel": "K5_replay_draw", "shape": [K5_SLOTS, groups, K5_BATCH],
                  "twin_mismatches": int((idx != twin).sum()),
                  "ms": time_ms(torch, lambda: replay_draw(p, u), reps=REPS),
                  "plain_ms": time_ms(torch, lambda: replay_draw_plain(p, u), reps=REPS),
                  "library_ms": time_ms(torch, lambda: torch.searchsorted(
                      torch.cumsum(p, 0), u_abs, right=True), reps=REPS),
                  "bound_ms": bms, "bound_by": by})

    if wanted("k5f", None):
        from rainbow_iqn_apex_tpu_torch.kernels.frontier_draw import (
            frontier_draw,
            frontier_draw_plain,
        )

        groups, beta, n_items = 8, 0.4, float(K5_SLOTS // 2)
        p = torch.rand((K5_SLOTS,), generator=gen, device=dev)
        p[torch.rand((K5_SLOTS,), generator=gen, device=dev) < 0.3] = 0.0
        p[K5_SLOTS // 2:] = 0.0  # one live shard of two
        u = torch.rand((groups, K5_BATCH), generator=gen, device=dev)
        got, want = frontier_draw(p, u, beta, n_items), frontier_draw_plain(p, u, beta, n_items)
        same = got[0] == want[0]
        kb = torch.arange(K5_BATCH, device=dev, dtype=torch.float32)

        def library():
            cdf = torch.cumsum(p, 0)
            ids = torch.searchsorted(cdf, (kb + u) / K5_BATCH * cdf[-1], right=True).clamp_(
                max=K5_SLOTS - 1)
            w = torch.pow(n_items * (p[ids] / cdf[-1]), -beta)
            return w / w.amax(dim=1, keepdim=True)
        nbytes = K5_SLOTS * 4 + groups * K5_BATCH * 4 + 3 * groups * K5_BATCH * 4
        bms, by = bound_ms(nbytes, K5_SLOTS, FP32_FLOPS)
        emit({"kernel": "K5f_frontier_draw", "shape": [K5_SLOTS, groups, K5_BATCH],
              "twin_mismatches": int((~same).sum()),
              "max_abs_err": float((got[2] - want[2]).abs()[same].max()),
              "ms": time_ms(torch, lambda: frontier_draw(p, u, beta, n_items), reps=REPS),
              "plain_ms": time_ms(torch, lambda: frontier_draw_plain(p, u, beta, n_items),
                                  reps=REPS),
              "library_ms": time_ms(torch, library, reps=REPS), "bound_ms": bms, "bound_by": by})
    if wanted("k4", None):
        bench_k4(torch, dev, gen, emit, bound_ms, time_ms, _mt_mask, FP32_FLOPS)
    if wanted("k12", None):
        bench_k12(torch, dev, emit, bound_ms, time_ms, _game_bytes, GAME_NAMES, FP32_FLOPS)
    if wanted("k1", None):
        bench_k1(torch, dev, gen, emit, bound_ms, time_ms, K1_OPS_PER_PAIR, FP32_FLOPS)
    if wanted("k7", None):
        bench_k7(torch, dev, emit, bound_ms, time_ms, _replay_ticks, FP32_FLOPS)
    if wanted("k8", None):
        bench_k8(torch, dev, emit, bound_ms, time_ms, _replay_ticks, FP32_FLOPS)
    if wanted("k6", None):
        bench_k6(torch, dev, gen, emit, bound_ms, time_ms, K1_OPS_PER_PAIR, FP32_FLOPS)
    if wanted("k6f", None):
        bench_k6f(torch, dev, gen, emit, bound_ms, time_ms, FP32_FLOPS)
    if wanted("k11", None):
        bench_k11(torch, dev, gen, emit, time_ms)
    if wanted("k7s", None):
        bench_k7s(torch, dev, emit, time_ms)
    return 0


def _ring(torch, dev, seg, frame, replay_ticks, ticks=None):
    """A DeviceReplay of REPLAY_LANES lanes x ``seg`` slots filled through
    K7 with ``ticks`` (default 2 seg + 5) ticks of chip_smoke.py's synthetic
    experience."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.replay.device import DeviceReplay

    ring = DeviceReplay(lanes=REPLAY_LANES, seg=seg, frame_shape=frame, history=REPLAY_H,
                        n_step=REPLAY_N, gamma=0.99, device=dev)
    state = ring.init_state()
    ticks = 2 * seg + 5 if ticks is None else ticks
    data = [torch.from_numpy(a).to(dev) for a in replay_ticks(
        np, np.random.default_rng(12), ticks, REPLAY_LANES, frame)]
    for t in range(ticks):
        ring.append(state, *[a[t] for a in data])
    return ring, state, [a[0] for a in data]


def bench_k7(torch, dev, emit, bound_ms, time_ms, replay_ticks, fp32_flops):
    """K7 at the append ticks of the host-fed Anakin (16 lanes of 84 x 84) and
    the fused Anakin (80 x 80) on chip_smoke.py's wrapped 64-slot ring, each
    tick at one cursor, beside the twin and the byte bound counted as
    chip_smoke.py counts it."""
    from rainbow_iqn_apex_tpu_torch.kernels.replay_append import (
        replay_append,
        replay_append_plain,
    )

    lanes, h, n = REPLAY_LANES, REPLAY_H, REPLAY_N
    for frame in ((84, 84), (80, 80)):
        ring, got, tick = _ring(torch, dev, WARM_SEG, frame, replay_ticks)
        want = got.to(dev)
        args = (got.pos, got.filled, h, n, ring.eps, ring.omega)
        replay_append(got, *tick, *args)
        replay_append_plain(want, *tick, *args)
        same = all(torch.equal(getattr(got, f), getattr(want, f)) for f in
                   ("frames", "actions", "rewards", "terminals", "cuts", "priority",
                    "max_priority"))
        hw = frame[0] * frame[1]
        nbytes = lanes * (2 * hw + 2 * (4 + 4 + 1 + 1) + 4 + (h + 2) * 4 + 4)
        bms, by = bound_ms(nbytes, lanes * 8, fp32_flops)
        emit({"kernel": "K7_replay_append", "ring": "warm", "shape": [lanes, WARM_SEG, *frame],
              "exact": same, "ms": time_ms(torch, lambda: replay_append(got, *tick, *args)),
              "plain_ms": time_ms(torch, lambda: replay_append_plain(want, *tick, *args)),
              "bound_ms": bms, "bound_by": by})


def bench_k8(torch, dev, emit, bound_ms, time_ms, replay_ticks, fp32_flops):
    """K8 at the learn batches of the host-fed Anakin ([32, 84, 84, 4]) and the
    fused Anakin's jaxgame frames ([32, 80, 80, 4]), G 1 and 4, n 3: on
    chip_smoke.py's wrapped 64-slot ring (warm: its ~7 MB of frames stay in
    L2), and on a ring of COLD_SEG slots a lane (>= 200 MB of frames) where
    each call draws its own ids spread over the ring, COLD_SETS sets in
    turn, so a call finds its frames out of L2 (a warm read of device
    memory: the cache is not flushed, only outrun).  Beside the twin and the
    byte bound counted as chip_smoke.py counts it."""
    import itertools

    from rainbow_iqn_apex_tpu_torch.kernels.replay_assemble import (
        replay_assemble,
        replay_assemble_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.replay_draw import replay_draw

    h, n, batch, lanes = REPLAY_H, REPLAY_N, K5_BATCH, REPLAY_LANES
    gen = torch.Generator(device=dev).manual_seed(13)
    for frame in ((84, 84), (80, 80)):
        hw = frame[0] * frame[1]
        warm_ring, warm, _ = _ring(torch, dev, WARM_SEG, frame, replay_ticks)
        cold_ring, cold, _ = _ring(torch, dev, COLD_SEG, frame, replay_ticks, ticks=COLD_SEG)
        for groups in (1, 4):
            m = groups * batch
            frames_read = min(2 * h, h + n)  # obs and next_obs share h - n frames
            nbytes = m * (frames_read * hw + 2 * h * hw + 4 + n * (4 + 1) + 2 * (h - 1)
                          + 4 + 4 * 4 + 4)
            bms, by = bound_ms(nbytes, m * n * 4, fp32_flops)
            for name, ring, state in (("warm", warm_ring, warm), ("cold", cold_ring, cold)):
                slots = lanes * state.actions.shape[1]
                sets = [torch.randint(0, slots, (m,), generator=gen, device=dev,
                                      dtype=torch.int32) for _ in range(COLD_SETS)]
                _, total = replay_draw(state.priority, state.priority.new_empty((0, 1)))

                def call(ids):
                    return replay_assemble(state, ids, total, ring._gammas, 0.6, state.filled,
                                           h, n, batch)
                a = call(sets[0])
                b = replay_assemble_plain(state, sets[0], total, ring._gammas, 0.6,
                                          state.filled, h, n, batch)
                exact = all(torch.equal(getattr(a, f), getattr(b, f))
                            for f in ("obs", "next_obs", "action", "discount"))
                rel = max(float(((getattr(a, f) - getattr(b, f)).abs()
                                 / getattr(b, f).abs().clamp_min(1e-30)).max())
                          for f in ("reward", "prob", "weight"))
                row = {"kernel": "K8_replay_assemble", "ring": name,
                       "ring_frame_bytes": state.frames.numel(),
                       "shape": [groups, batch, *frame, h], "n_step": n, "stacks_exact": exact,
                       "max_rel_err": rel, "bound_ms": bms, "bound_by": by}
                if name == "warm":
                    row["ms"] = time_ms(torch, lambda: call(sets[0]))
                    row["plain_ms"] = time_ms(torch, lambda: replay_assemble_plain(
                        state, sets[0], total, ring._gammas, 0.6, state.filled, h, n, batch))
                else:  # COLD_BURST calls a timed call, each on the next id set
                    turn = itertools.cycle(range(COLD_SETS))
                    row["ms"] = time_ms(torch, lambda: [call(sets[next(turn)])
                                                        for _ in range(COLD_BURST)]) / COLD_BURST
                emit(row)
        del warm, cold, warm_ring, cold_ring
        torch.cuda.empty_cache()


def bench_k1(torch, dev, gen, emit, bound_ms, time_ms, ops_per_pair, fp32_flops):
    """The learn step's loss chain at B 32, N = N' = 64, A 18: K1 per-sample,
    K1 weighted, K4-bwd's dz and loss modes, and the chain from the heads launch to K3-bwd, pass 1
    and a reuse pass: the tree's route (three launches where it has K1's
    weighted mode) and the parent's eight ops (nine in a reuse pass) on
    every tree."""
    from rainbow_iqn_apex_tpu_torch.kernels import dueling_head as k4
    from rainbow_iqn_apex_tpu_torch.kernels import quantile_huber as k1

    batch, n, n_t, actions = 32, 64, 64, 18
    m = batch * n
    online = torch.randn((batch, n), generator=gen, device=dev)
    taus = torch.rand((batch, n), generator=gen, device=dev)
    target = torch.randn((batch, n_t), generator=gen, device=dev)
    weight = torch.rand((batch,), generator=gen, device=dev) + 0.1
    scale = torch.rand((batch,), generator=gen, device=dev) + 0.5
    take = torch.randint(0, actions, (batch,), generator=gen, device=dev, dtype=torch.int32)
    dz = torch.randn((batch, n), generator=gen, device=dev)
    weighted = hasattr(k1, "quantile_huber_weighted")
    k1_bytes = (2 * batch * n + batch * n_t) * 4 + (2 * batch + batch * n) * 4
    bms, by = bound_ms(k1_bytes, ops_per_pair * batch * n * n_t, fp32_flops)
    emit({"kernel": "K1_quantile_huber", "mode": "per_sample", "shape": [batch, n, n_t],
          "ms": time_ms(torch, lambda: k1.quantile_huber(online, taus, target, 1.0), reps=REPS),
          "bound_ms": bms, "bound_by": by})
    if weighted:
        bms, by = bound_ms(k1_bytes + batch * 4 + 4, ops_per_pair * batch * n * n_t, fp32_flops)
        emit({"kernel": "K1_quantile_huber", "mode": "weighted", "shape": [batch, n, n_t],
              "ms": time_ms(torch, lambda: k1.quantile_huber_weighted(
                  online, taus, target, weight, None, 1.0), reps=REPS),
              "bound_ms": bms, "bound_by": by})
    bms, by = bound_ms(batch * n * 4 + batch * 4 + m * 4 + m * actions * 4, 2 * m * actions,
                       fp32_flops)
    emit({"kernel": "K4_dueling_head_bwd", "mode": "dz", "shape": [batch, n, actions],
          "ms": time_ms(torch, lambda: k4.dueling_gather_bwd(dz, take, actions, True), reps=REPS),
          "bound_ms": bms, "bound_by": by})
    grad = k1.quantile_huber(online, taus, target, 1.0)[2]
    d_loss = torch.full((), 2.5, device=dev)
    if weighted:
        bms, by = bound_ms(4 + 2 * batch * 4 + batch * n * 4 + m * 4 + m * actions * 4,
                           2 * m * actions + 3 * m, fp32_flops)
        emit({"kernel": "K4_dueling_head_bwd", "mode": "loss", "shape": [batch, n, actions],
              "ms": time_ms(torch, lambda: k4.dueling_loss_bwd(d_loss, weight, None, grad, take,
                                                              actions, True), reps=REPS),
              "bound_ms": bms, "bound_by": by})
    for name, sc in (("pass_1", None), ("reuse_pass", scale)):
        def parent(sc=sc):
            loss_b, _, g = k1.quantile_huber(online, taus, target, 1.0)
            w = weight if sc is None else weight * sc
            loss = torch.mean(w * loss_b)
            d_ps = torch.ones_like(loss).expand(batch) / batch * w
            return k4.dueling_gather_bwd(d_ps[:, None] * g, take, actions, True)

        def route(sc=sc):
            if not weighted:
                return parent(sc)
            loss, _, _, g = k1.quantile_huber_weighted(online, taus, target, weight, sc, 1.0)
            return k4.dueling_loss_bwd(torch.ones_like(loss), weight, sc, g, take, actions, True)

        emit({"kernel": "loss_chain", "at": name, "shape": [batch, n, n_t, actions],
              "launches": 3 if weighted else 8 + (sc is not None),
              "ms": time_ms(torch, route, reps=REPS),
              "parent_route_ms": time_ms(torch, parent, reps=REPS)})


def bench_k6(torch, dev, gen, emit, bound_ms, time_ms, ops_per_pair, fp32_flops):
    """K6 with the loss that feeds it, at the fused Anakin step's B 32 a
    group, N = N' = 64, over K5_SLOTS priorities, G 1 and 4."""
    from rainbow_iqn_apex_tpu_torch.kernels import quantile_huber as k1
    from rainbow_iqn_apex_tpu_torch.kernels import replay_writeback as k6

    fold = hasattr(k6, "Writeback")
    eps, omega, n = 1e-6, 0.5, 64
    ring = torch.rand((K5_SLOTS,), generator=gen, device=dev) + 0.1
    max_p = torch.tensor(1.0, device=dev)
    for groups in (1, 4):
        batch = groups * K5_BATCH
        online = torch.randn((batch, n), generator=gen, device=dev)
        taus = torch.rand((batch, n), generator=gen, device=dev)
        target = torch.randn((batch, n), generator=gen, device=dev)
        weight = torch.rand((batch,), generator=gen, device=dev) + 0.1
        ids = torch.randint(0, K5_SLOTS, (groups, K5_BATCH), generator=gen, device=dev,
                            dtype=torch.int32)
        td = k1.quantile_huber_weighted(online, taus, target, weight, None, 1.0)[2]

        def two_launches():
            out = k1.quantile_huber_weighted(online, taus, target, weight, None, 1.0)
            k6.replay_writeback(ring, max_p, ids, out[2], eps, omega)

        def route():
            if not fold:
                return two_launches()
            k1.quantile_huber_weighted(online, taus, target, weight, None, 1.0,
                                       k6.Writeback(ring, max_p, ids, eps, omega))

        # K1: online, taus, target and weight in; per_sample, td_abs, grad, mean out
        k1_bytes = (3 * batch * n + batch + 2 * batch + batch * n) * 4 + 4
        k6_bytes = batch * 4 * 4 + 8  # ids and td in, each slot's p in and out, max_priority
        # the fold: K1's bytes, the ids and p in and out (td_abs never leaves the launch)
        bms, by = bound_ms(k1_bytes + batch * 3 * 4 + 8, ops_per_pair * batch * n * n,
                           fp32_flops)
        emit({"kernel": "K6_replay_writeback", "at": "fused_step", "shape": [groups, K5_BATCH],
              "route": "K1 with K6 folded in" if fold else "K1, then K6",
              "ms": time_ms(torch, route, reps=REPS),
              "two_launch_ms": time_ms(torch, two_launches, reps=REPS),
              "k1_weighted_ms": time_ms(torch, lambda: k1.quantile_huber_weighted(
                  online, taus, target, weight, None, 1.0), reps=REPS),
              "k6_ms": time_ms(torch, lambda: k6.replay_writeback(ring, max_p, ids, td, eps,
                                                                  omega), reps=REPS),
              "k6_bound_ms": bound_ms(k6_bytes, 2 * batch, fp32_flops)[0],
              "bound_ms": bms, "bound_by": by})


def bench_k6f(torch, dev, gen, emit, bound_ms, time_ms, fp32_flops):
    """The apex loop's mirror updates between two draws and the draw, over
    K5_SLOTS slots (one live shard of two), G 8, B K5_BATCH."""
    from rainbow_iqn_apex_tpu_torch.kernels import frontier_writeback as k6f
    from rainbow_iqn_apex_tpu_torch.kernels.frontier_draw import frontier_draw

    queue_mode = hasattr(k6f, "MirrorQueue")
    eps, omega, groups, beta, n_items = 1e-6, 0.5, 8, 0.4, float(K5_SLOTS // 2)
    mirror = torch.rand((K5_SLOTS,), generator=gen, device=dev) + 0.1
    mirror[K5_SLOTS // 2:] = 0.0
    u = torch.rand((groups, K5_BATCH), generator=gen, device=dev)
    batches = [(torch.randint(0, K5_SLOTS // 2, (K5_BATCH,), generator=gen, device=dev,
                              dtype=torch.int32),
                torch.randn((K5_BATCH,), generator=gen, device=dev)) for _ in range(8)]
    staged = [(torch.randperm(K5_SLOTS // 2, generator=gen, device=dev)[:16],
               torch.rand((16,), generator=gen, device=dev)) for _ in range(2)]
    order = [("w", 0), ("w", 1), ("w", 2), ("w", 3), ("s", 0), ("w", 4), ("w", 5), ("w", 6),
             ("w", 7), ("s", 1)]  # a tick's appends every 4 learn steps

    def parent_route():
        for kind, i in order:
            if kind == "w":
                k6f.frontier_writeback(mirror, *batches[i], eps, omega)
            else:
                mirror.index_copy_(0, staged[i][0], staged[i][1])
        return frontier_draw(mirror, u, beta, n_items)

    queue = None
    if queue_mode:
        queue = k6f.MirrorQueue(eps, omega)
        for kind, i in order:
            if kind == "w":
                queue.writeback(*batches[i])
            else:
                queue.stage(staged[i][0].to(torch.int32), staged[i][1])

    def route():
        if queue is None:
            return parent_route()
        return frontier_draw(mirror, u, beta, n_items, queue)

    entries = 8 * K5_BATCH + 2 * 16
    nbytes = K5_SLOTS * 4 + entries * 4 * 4 + groups * K5_BATCH * 4 * 4
    bms, by = bound_ms(nbytes, K5_SLOTS, fp32_flops)
    row = {"kernel": "K6f_frontier_writeback", "at": "between_draws",
           "shape": [K5_SLOTS, groups, K5_BATCH], "queue": "8 x 32 write-back, 2 x 16 staged",
           "route": "K5f applying the queue" if queue_mode else "8 K6f, 2 index_copy_, K5f",
           "ms": time_ms(torch, route, reps=REPS),
           "parent_route_ms": time_ms(torch, parent_route, reps=REPS),
           "k5f_ms": time_ms(torch, lambda: frontier_draw(mirror, u, beta, n_items), reps=REPS),
           "k6f_ms": time_ms(torch, lambda: k6f.frontier_writeback(mirror, *batches[0], eps,
                                                                   omega), reps=REPS),
           "k6f_bound_ms": bound_ms(K5_BATCH * 4 * 4, 2 * K5_BATCH, fp32_flops)[0],
           "bound_ms": bms, "bound_by": by}
    if queue_mode:
        row["apply_ms"] = time_ms(torch, lambda: k6f.frontier_apply(mirror, queue), reps=REPS)
    emit(row)


def bench_k4(torch, dev, gen, emit, bound_ms, time_ms, mt_mask, fp32_flops):
    from rainbow_iqn_apex_tpu_torch.kernels import dueling_head as k4

    def head(batch, taus, actions):
        return (torch.randn((batch * taus, 1), generator=gen, device=dev),
                torch.randn((batch * taus, actions), generator=gen, device=dev), taus)

    def mode_bound(m, batch, actions, extra_bytes=0):
        return bound_ms(m * 4 + 2 * m * actions * 4 + batch * actions * 4 + batch * 4 + extra_bytes,
                        4 * m * actions, fp32_flops)

    for name, batch, taus, actions in (("bucket64", 64, 32, 18), ("r2d2", 2560, 1, 18)):
        value, adv, _ = head(batch, taus, actions)
        bms, by = mode_bound(batch * taus, batch, actions)
        emit({"kernel": "K4_dueling_head", "mode": "greedy", "at": name,
              "shape": [batch, taus, actions],
              "ms": time_ms(torch, lambda: k4.dueling_head(value, adv, taus), reps=REPS),
              "bound_ms": bms, "bound_by": by})
    for name, batch, taus, actions in (("learn", 32, 64, 18), ("r2d2", 2560, 1, 18)):
        value, adv, _ = head(batch, taus, actions)
        take = torch.randint(0, actions, (batch,), generator=gen, device=dev, dtype=torch.int32)
        bms, by = bound_ms(batch * taus * 4 * (1 + actions) + batch * 4 + batch * taus * 4
                           + batch * actions * 4, 4 * batch * taus * actions, fp32_flops)
        emit({"kernel": "K4_dueling_head", "mode": "gather", "at": name,
              "shape": [batch, taus, actions],
              "ms": time_ms(torch, lambda: k4.dueling_gather(value, adv, taus, take), reps=REPS),
              "bound_ms": bms, "bound_by": by})
    for name, batch, taus, actions, counts in (("path", 32, 32, 5, (3, 5, 4, 3)),
                                               ("serving", 64, 32, 18, (18, 9, 6, 4))):
        value, adv, _ = head(batch, taus, actions)
        game = (torch.arange(batch, device=dev, dtype=torch.int32) % 4).contiguous()
        mask = mt_mask(torch, counts, actions, dev)
        bms, by = mode_bound(batch * taus, batch, actions, batch * 4 + 4 * actions)
        emit({"kernel": "K4m_dueling_head_mask", "at": name, "shape": [batch, taus, actions],
              "ms": time_ms(torch, lambda: k4.dueling_head(value, adv, taus, game, mask),
                            reps=REPS), "bound_ms": bms, "bound_by": by})
        limit = torch.tensor(counts, device=dev)[game.long()]
        take = (torch.arange(batch, device=dev) % limit).to(torch.int32)
        for masked in (True, False):
            margs = (game, mask) if masked else ()
            emit({"kernel": "K4l_dueling_head_logp", "at": name, "masked": masked,
                  "shape": [batch, taus, actions],
                  "ms": time_ms(torch, lambda: k4.dueling_logp(value, adv, taus, take, *margs),
                                reps=REPS), "bound_ms": bms, "bound_by": by})
    # a learn step's heads: the select head at K taus, the target at N', the online at N
    for name, (batch, k, n_prime, n, actions), counts in (
            ("learn", (32, 32, 64, 64, 18), None), ("path", (32, 32, 64, 64, 5), (3, 5, 4, 3))):
        select, target, online = head(batch, k, actions), head(batch, n_prime, actions), \
            head(batch, n, actions)
        take = torch.randint(0, actions, (batch,), generator=gen, device=dev, dtype=torch.int32)
        reward = torch.randn((batch,), generator=gen, device=dev)
        discount = torch.full((batch,), 0.99 ** 3, device=dev)
        margs = (None, None)
        if counts is not None:
            margs = ((torch.arange(batch, device=dev, dtype=torch.int32) % 4).contiguous(),
                     mt_mask(torch, counts, actions, dev))

        def three_launches():
            a_star = k4.dueling_head(*select, *[x for x in margs if x is not None])[2]
            z_next, _ = k4.dueling_gather(*target, a_star)
            td = reward[:, None] + discount[:, None] * z_next
            return k4.dueling_gather(*online, take), td

        def route():
            if hasattr(k4, "dueling_learn"):
                return k4.dueling_learn(select, target, online, take, reward, discount, *margs)
            return three_launches()

        rows = batch * (k + n_prime + n)
        bms, by = bound_ms(rows * 4 * (1 + actions) + 4 * batch * 4 + 2 * batch * n_prime * 4
                           + batch * n * 4 + batch * actions * 4, 4 * rows * actions, fp32_flops)
        emit({"kernel": "K4m_dueling_head_mask" if counts else "K4_dueling_head", "mode": "heads",
              "at": name, "shape": [batch, k, n_prime, n, actions],
              "launches": 1 if hasattr(k4, "dueling_learn") else 3,
              "ms": time_ms(torch, route, reps=REPS),
              "three_launch_ms": time_ms(torch, three_launches, reps=REPS),
              "bound_ms": bms, "bound_by": by})


def bench_k12(torch, dev, emit, bound_ms, time_ms, game_bytes, game_names, fp32_flops):
    from rainbow_iqn_apex_tpu_torch.envs import prng
    from rainbow_iqn_apex_tpu_torch.envs.device_games import make_device_game
    from rainbow_iqn_apex_tpu_torch.kernels.device_games import game_init, game_step, game_tick

    gen = torch.Generator(device=dev).manual_seed(5)
    for name in game_names:
        game = make_device_game(name)
        keys = prng.split(prng.prng_key(3), 8)
        for lanes in (16, 4096):
            state, _ = game_init(game, keys[0], lanes, dev)
            ep = torch.zeros(lanes, device=dev)
            a = torch.randint(0, game.num_actions, (lanes,), generator=gen, device=dev,
                              dtype=torch.int32)
            bms, by = bound_ms(game_bytes(torch, game, lanes), 0.0, fp32_flops)
            emit({"kernel": "K12_device_games", "game": name, "lanes": lanes, "mode": "tick",
                  "ms": time_ms(torch, lambda: game_tick(game, state, ep, a, keys[1]), reps=REPS),
                  "bound_ms": bms, "bound_by": by})
        a = torch.randint(0, game.num_actions, (1,), generator=gen, device=dev, dtype=torch.int32)

        def reset_and_step():
            state, _ = game_init(game, keys[2], 1, dev, direct=True)
            return game_step(game, state, a, keys[3])

        reset_ms = time_ms(torch, lambda: game_init(game, keys[2], 1, dev, direct=True), reps=REPS)
        both_ms = time_ms(torch, reset_and_step, reps=REPS)
        bms, by = bound_ms(game_bytes(torch, game, 1), 0.0, fp32_flops)
        emit({"kernel": "K12_device_games", "game": name, "lanes": 1, "mode": "step",
              "ms": both_ms - reset_ms, "reset_and_step_ms": both_ms, "reset_ms": reset_ms,
              "bound_ms": bms, "bound_by": by})


# K11 / K7s: the reference config's R2D2 Anakin learner and act tick
R2D2_BURN, R2D2_T, R2D2_A, R2D2_N = 40, 80, 18, 3
R2D2_RING = 8333  # the uncut ring's sequences
R2D2_LANES, R2D2_LSTM, R2D2_HIST = 16, 512, 4


def bench_k11(torch, dev, gen, emit, time_ms):
    """K11 at the learner's [B 32, T 80, A 18], n 3, G 1 and 4, as the R2D2
    step runs it on this tree: ``k11_ms`` one launch on contiguous inputs;
    ``learn_route_ms`` the learn step's epilogue (the tree's: the train
    slices of reward, done and valid read in place where K11 takes strides,
    else three ``.contiguous()`` copies, then K11); ``fused_ms`` the fused
    Anakin step's epilogue (with K6s folded into K11 where the tree has the
    fold, else K11's route then K6s over the 8,333 priorities);
    ``two_launch_ms`` K11 then K6s on contiguous inputs, on every tree."""
    from rainbow_iqn_apex_tpu_torch.kernels import r2d2_td as k11
    from rainbow_iqn_apex_tpu_torch.kernels.seq_writeback import seq_writeback

    fold = hasattr(k11, "td_plan")
    seq = R2D2_BURN + R2D2_T
    p = k11.TDParams(R2D2_N, 0.997, 0.9, 1e-3)
    ring = torch.rand((R2D2_RING,), generator=gen, device=dev) + 0.05
    top = torch.tensor(1.0, device=dev)
    for groups in (1, 4):
        rows = 32 * groups

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev) * 3

        q = (rnd(rows, R2D2_T), rnd(rows, R2D2_T, R2D2_A), rnd(rows, R2D2_T, R2D2_A))
        full = (rnd(rows, seq) / 3, torch.rand((rows, seq), generator=gen, device=dev) < 0.02,
                torch.ones((rows, seq), dtype=torch.bool, device=dev))
        weight = torch.rand((rows,), generator=gen, device=dev) * 0.7 + 0.3
        sliced = [t[:, R2D2_BURN:] for t in full]
        copied = [t.contiguous() for t in sliced]
        ids = torch.randint(0, R2D2_RING, (groups, 32), generator=gen, device=dev,
                            dtype=torch.int32)

        def learn_route():
            ins = sliced if fold else [t.contiguous() for t in sliced]
            return k11.r2d2_td(*q, *ins, weight, p)

        def two_launches(ins=copied):
            out = k11.r2d2_td(*q, *ins, weight, p)
            seq_writeback(ring, top, ids, out[1], 1e-6, 0.9)

        def fused():
            if not fold:
                return two_launches([t.contiguous() for t in sliced])
            return k11.r2d2_td(*q, *sliced, weight, p,
                               k11.Writeback(ring, top, ids, 1e-6, 0.9))

        emit({"kernel": "K11_r2d2_td", "shape": [rows, R2D2_T, R2D2_A], "groups": groups,
              "route": "K11 with K6s folded in, strided slices" if fold
              else "three copies, K11, then K6s",
              "k11_ms": time_ms(torch, lambda: k11.r2d2_td(*q, *copied, weight, p)),
              "learn_route_ms": time_ms(torch, learn_route), "fused_ms": time_ms(torch, fused),
              "two_launch_ms": time_ms(torch, two_launches)})


def bench_k7s(torch, dev, emit, time_ms):
    """The R2D2 act tick's work before the act at the reference config (16
    lanes, 84 x 84, history 4, LSTM 512, L 120, stride 80) on a quiet tick
    (no lane emits) and one where every lane emits a full window: ``ms`` the
    tree's route (one K7s prologue launch where the tree has
    ``act_prologue``, else K7s's append, ``shift_stack`` and the two
    multiplies of pre), ``append_ms`` K7s's append alone (on a quiet tick the
    lane plan's launch parameters dominate: the tree's size of them), and
    ``parent_route_ms`` the latter route on every tree."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.kernels import seq_append as k7s
    from rainbow_iqn_apex_tpu_torch.parallel.multihost import shift_stack
    from rainbow_iqn_apex_tpu_torch.replay.device_sequence import DeviceSequenceReplay

    seq, stride = R2D2_BURN + R2D2_T, R2D2_T
    lanes, lstm, frame = R2D2_LANES, R2D2_LSTM, (84, 84)
    replay = DeviceSequenceReplay(R2D2_RING, seq, frame, lstm, lanes, stride, device=dev)
    state = replay.init_state()
    rng = np.random.default_rng(21)
    frames = torch.from_numpy(rng.integers(0, 256, (lanes, *frame), dtype=np.uint8)).to(dev)
    actions = torch.from_numpy(rng.integers(0, 18, lanes).astype(np.int32)).to(dev)
    c, h = (torch.from_numpy(rng.normal(size=(lanes, lstm)).astype(np.float32)).to(dev)
            for _ in range(2))
    rewards = rng.normal(size=lanes).astype(np.float32)
    cut = np.zeros(lanes, bool)
    stack = torch.zeros((lanes, *frame, R2D2_HIST), dtype=torch.uint8, device=dev)
    keep = torch.ones(lanes, dtype=torch.uint8, device=dev)
    prologue = hasattr(k7s, "act_prologue")
    for name, buf_len in (("no_lane_emits", np.zeros(lanes, np.int32)),
                          ("all_lanes_emit", np.full(lanes, seq - 1, np.int32))):
        plan = k7s.plan_append(buf_len, cut, cut, 0, R2D2_RING, R2D2_RING, seq, stride)
        args = (frames, actions, rewards, cut, c, h)

        def append():
            k7s.seq_append(state, *args, plan, stride)

        def parent_route():
            append()
            shift_stack(stack, frames, keep)
            kf = keep.to(torch.float32)[:, None]
            return c * kf, h * kf

        def route():
            if not prologue:
                return parent_route()
            return k7s.act_prologue(state, args, plan, stride, stack, frames, keep, c, h)

        emit({"kernel": "K7s_seq_append", "tick": name, "shape": [lanes, seq, *frame, lstm],
              "route": "one K7s prologue launch" if prologue
              else "K7s, shift_stack (3 ops), pre (3 ops)",
              "ms": time_ms(torch, route), "append_ms": time_ms(torch, append),
              "parent_route_ms": time_ms(torch, parent_route)})


if __name__ == "__main__":
    sys.exit(main())
