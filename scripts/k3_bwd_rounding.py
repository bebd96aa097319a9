#!/usr/bin/env python3
"""Which side rounds K3-bwd's dxc away from the exact value: the kernel or
its fp32 twin.

dxc = bf16(bf16(dy @ W_mu) + bf16(bf16(dys @ W_sigma) * bf16(f_in))).  The
kernel forms the two products from bf16 hi / lo halves of dy on the tensor
cores, the twin (``noisy_linear_bwd_plain``) in fp32 through cuBLAS.  This
script feeds both the inputs of the card test at a given shape
(``tests/test_torch_kernels.py:test_k3_bwd_kernel_matches_plain``, noisy,
ReLU), computes the same expression from fp64 products (the exact value
rounded at the same points), and counts, per side, the dxc elements that
differ from it and those outside the test's bound (1e-2 + 1e-2 |ref|).

    python3 scripts/k3_bwd_rounding.py --shape 3840,512,512

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
    ap.add_argument("--shape", default="3840,512,512", help="M,K,N")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k3_bwd_rounding: needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    sys.path.insert(0, ROOT)
    from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear import (
        noisy_linear_bwd,
        noisy_linear_bwd_plain,
        noisy_linear_plain,
    )
    from rainbow_iqn_apex_tpu_torch.models.layers import _f

    def _t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)

    def _k3_inputs(m, k, n, seed=1):  # tests/test_torch_kernels.py's draws
        r = np.random.default_rng(seed)
        return (r.standard_normal((m, k)).astype(np.float32),
                {"w_mu": (r.uniform(-1, 1, (k, n)) * k ** -0.5).astype(np.float32),
                 "b_mu": (r.standard_normal(n) * 0.1).astype(np.float32),
                 "w_sigma": (r.uniform(0.2, 1.0, (k, n)) * k ** -0.5).astype(np.float32),
                 "b_sigma": (r.uniform(0.2, 1.0, n) * 0.1).astype(np.float32)},
                r.standard_normal(k).astype(np.float32),
                r.standard_normal(n).astype(np.float32))

    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = (int(v) for v in args.shape.split(","))
    dev, bf = torch.device("cuda", 0), torch.bfloat16
    x, p, e_in, e_out = _k3_inputs(m, k, n)  # the card test's inputs, noisy and ReLU
    xc, w_mu = _t(x, bf).to(dev), _t(p["w_mu"].T, bf).to(dev)
    g = _t(np.random.default_rng(22).standard_normal((m, n))).to(dev)
    y = noisy_linear_plain(xc, w_mu, _t(p["b_mu"]).to(dev), relu=True)
    w_sigma, f_in, f_out = _t(p["w_sigma"].T, bf).to(dev), _f(_t(e_in)).to(dev), _f(_t(e_out)).to(dev)
    args_ = (g, y, xc, w_mu, w_sigma, f_in, f_out)
    kernel = noisy_linear_bwd(*args_)[0].float()
    twin = noisy_linear_bwd_plain(*args_)[0].float()

    dy = torch.where(y > 0, g, torch.zeros_like(g))
    dys = dy * f_out
    mu = (dy.double() @ w_mu.double()).to(bf)
    sg = (dys.double() @ w_sigma.double()).to(bf)
    exact = (mu + sg * f_in.to(bf)).float()  # bf16 ops: each rounds once, as the jaxpr

    def tally(got):
        diff = (got - exact).abs()
        outside = diff > 1e-2 + 1e-2 * exact.abs()
        return {"differ": int((diff > 0).sum()), "outside_bound": int(outside.sum()),
                "max_abs": float(diff.max())}

    between = (kernel - twin).abs()
    print(json.dumps({"shape": [m, k, n], "device": torch.cuda.get_device_name(0),
                      "elements": kernel.numel(), "kernel_vs_exact": tally(kernel),
                      "twin_vs_exact": tally(twin),
                      "kernel_vs_twin_outside_bound": int(
                          (between > 1e-2 + 1e-2 * twin.abs()).sum())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
