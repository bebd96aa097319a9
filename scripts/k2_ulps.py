#!/usr/bin/env python3
"""K2's and K2-bwd's error in bf16 units of the last place, beside the plain
twin's, against an fp64 evaluation of the same rounding points.

For each shape, the kernels (on the card) and the plain twins (on the card's
fp32 torch ops) compute h, dphi, dW_e and db from the same seeded inputs; the
reference computes the Dense product and every sum in fp64 from the same bf16
cos features and rounds to bf16 only where the JAX model rounds (the Dense
output, the bias add, the products with dh and phi), leaving the sums
unrounded.  Prints, for each output and each side, the share of elements
more than half an ulp and more than one and a half ulps away, and the
largest distance: a kernel whose shares match the twin's is as exact as the
twin.

    python3 scripts/k2_ulps.py [--shapes 32x8x2304x32,32x64x3136x64]

Needs a CUDA card: it exits with 2 where there is none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="32x8x2304x32,32x64x3136x64,16x8x2304x32",
                    help="comma-separated B x N x F x C")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k2_ulps: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from rainbow_iqn_apex_tpu_torch.kernels.tau_embed import (
        _cos_features,
        tau_embed,
        tau_embed_bwd,
        tau_embed_bwd_plain,
        tau_embed_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf = torch.device("cuda", 0), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)

    def ulps(got, ref):
        got, ref = got.double(), ref.double()
        spacing = torch.where(ref.abs() > 0, 2.0 ** (torch.floor(torch.log2(ref.abs())) - 7),
                              torch.full_like(ref, 2.0 ** -133))
        return (got - ref).abs() / spacing

    for shape in args.shapes.split(","):
        b, n, f, c = (int(v) for v in shape.split("x"))
        taus = torch.rand((b, n), generator=gen, device=dev)
        w = (torch.randn((f, c), generator=gen, device=dev) * c ** -0.5).to(bf)
        bias = torch.randn((f,), generator=gen, device=dev) * 0.1
        phi = torch.randn((b, f), generator=gen, device=dev).relu().to(bf)
        dh = (torch.randn((b * n, f), generator=gen, device=dev) * 0.01).to(bf)
        h, cos_t = tau_embed(taus, w, bias, phi, save_cos=True)
        kernel = (h,) + tuple(tau_embed_bwd(taus, w, bias, phi, dh, cos_t=cos_t))
        twin = (tau_embed_plain(taus, w, bias, phi),) + tuple(
            tau_embed_bwd_plain(taus, w, bias, phi, dh))
        cos = _cos_features(taus, c, bf).reshape(b * n, c)
        pre = ((cos.double() @ w.double().t()).to(bf).float() + bias.to(bf).float()).to(bf)
        exact_h = (phi.float().repeat_interleave(n, 0) * pre.float().clamp_min(0)).to(bf)
        dh3, pre3 = dh.double().reshape(b, n, f), pre.double().reshape(b, n, f)
        dphi = (dh3 * pre3.clamp_min(0)).to(bf).double().sum(1)
        dpre = torch.where(pre3 > 0, (dh3 * phi.double()[:, None, :]).to(bf).double(),
                           torch.zeros_like(dh3)).reshape(b * n, f)
        exact = (exact_h, dphi, dpre.t() @ cos.double(), dpre.sum(0))
        for name, k, t, x in zip(("h", "dphi", "dW_e", "db_e"), kernel, twin, exact):
            row = {"shape": [b * n, f, c], "output": name, "elements": x.numel()}
            for side, got in (("kernel", k), ("twin", t)):
                u = ulps(got.float(), x)
                row[side] = {"over_half_ulp": float((u > 0.5).float().mean()),
                             "over_1_5_ulps": float((u > 1.5).float().mean()),
                             "max_ulps": float(u.max())}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
