#!/usr/bin/env python3
"""Per-layer times of K3 (the NoisyLinear GEMM) and K3-bwd on the card.

Times the port's ``noisy_linear`` and ``noisy_linear_bwd`` at every shape the
main paths give them (bucket 64's layers and ``chip_smoke.py``'s
``K3_EXTRA_SHAPES``: M 2048 / 1024 / 512 over F 3136 and the jaxgame F 2304,
the 512 -> 1 and 512 -> 18 out layers, the R2D2 head 512 -> 512 over B x T =
32 x 80 rows and at a 16-lane tick), each beside its plain twin's error, and
the host time of one wrapper call, with ``chip_smoke.py``'s timers.  The
port is imported from ``--root`` (default: this checkout), so two trees, e.g.
a parent commit unpacked into an ignored directory, are compared on one card
by running the script once per tree in one call:

    python3 scripts/bench_k3.py --label change
    python3 scripts/bench_k3.py --root parent --label parent

Prints one JSON object per (kernel, layer, mode); ``--out`` appends them to a
file as well; ``--only fwd`` (or ``bwd``, or layer names) times a subset.
Needs a CUDA card: it exits with 2 where there is none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 30  # CUDA-graph replays per time (median reported)

# (layer, M, K, N, relu): bucket 64's layers, then chip_smoke.py's other
# main-path shapes; K3-bwd runs on the learner's online pass, always noisy
FWD_SHAPES = [("hidden", 2048, 3136, 512, True), ("value_out", 2048, 512, 1, False),
              ("advantage_out", 2048, 512, 18, False)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--only", default=None,
                    help="comma-separated kernels (fwd, bwd) or layer names to time; default all")
    args = ap.parse_args()
    only = set(args.only.split(",")) if args.only else None

    def wanted(kind, name):
        return only is None or kind in only or name in only
    import torch

    if not torch.cuda.is_available():
        print("bench_k3: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import K3_EXTRA_SHAPES, host_us, time_ms

    shapes = FWD_SHAPES + list(K3_EXTRA_SHAPES)
    sys.path.insert(0, os.path.abspath(args.root))
    from rainbow_iqn_apex_tpu_torch.kernels import build
    from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear import (
        noisy_linear,
        noisy_linear_bwd,
        noisy_linear_bwd_plain,
        noisy_linear_plain,
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
