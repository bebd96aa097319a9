#!/usr/bin/env python
"""The JAX package's R2D2 catch run over several seeds: the reference beside
the port's ``catch_bar --role r2d2`` (and ``--role r2d2_anakin``).

Each seed runs ``rainbow_iqn_apex_tpu.train_r2d2.train_r2d2`` in its own
process on the arguments of ``rainbow_iqn_apex_tpu_torch.catch_bar``'s r2d2
scenario (the JAX test ``tests/test_r2d2.py::test_r2d2_learns_catch``, field
for field, 20,000 frames, in bf16 unless ``--compute-dtype float32`` asks for
the test's own dtype), a few processes at a time, on the CPU.  ``--role
anakin`` runs ``rainbow_iqn_apex_tpu.train_anakin_r2d2.train_anakin_r2d2``
on the r2d2_anakin scenario instead (the same arguments with ``--role
anakin``: the host-fed loop over the device sequence replay):

    env JAX_PLATFORMS=cpu PYTHONPATH=$PWD python scripts/r2d2_catch_jax.py --seeds 3-6
    env JAX_PLATFORMS=cpu PYTHONPATH=$PWD python scripts/r2d2_catch_jax.py --seeds 3-6 \
        --compute-dtype float32
    env JAX_PLATFORMS=cpu PYTHONPATH=$PWD python scripts/r2d2_catch_jax.py --seeds 3-6 \
        --role anakin

It prints one JSON line per run and one with the mean of the evaluations.
Results go under a temporary directory per run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rainbow_iqn_apex_tpu_torch import catch_bar  # noqa: E402  (jax-free)

_RUN = ("import json, sys; from rainbow_iqn_apex_tpu.config import parse_config; "
        "from rainbow_iqn_apex_tpu.{module} import {fn}; "
        "argv = sys.argv[1:]; i = argv.index('--max-frames'); frames = int(argv[i + 1]); "
        "del argv[i:i + 2]; "
        "print(json.dumps({fn}(parse_config(argv), max_frames=frames), default=float))")
# --role: (catch_bar scenario, JAX module, trainer)
_ROLES = {"single": ("r2d2", "train_r2d2", "train_r2d2"),
          "anakin": ("r2d2_anakin", "train_anakin_r2d2", "train_anakin_r2d2")}


def run(seed: int, compute_dtype: str = "", role: str = "single") -> dict:
    scenario, module, fn = _ROLES[role]
    with tempfile.TemporaryDirectory(prefix="r2d2_catch_jax_") as tmp:
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
        args = catch_bar.argv(scenario, seed, tmp, compute_dtype=compute_dtype)
        proc = subprocess.run([sys.executable, "-c", _RUN.format(module=module, fn=fn), *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    out = {"seed": seed, "role": role, "compute_dtype": compute_dtype or "bfloat16",
           "rc": proc.returncode}
    if proc.returncode != 0:
        out["error"] = proc.stderr[-2000:]
        return out
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    out.update(eval_score_mean=summary["eval_score_mean"], learn_steps=summary["learn_steps"],
               train_return_mean=summary["train_return_mean"])
    return out


def main(args=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="3-6")
    p.add_argument("--parallel", type=int, default=4)
    p.add_argument("--compute-dtype", default="",
                   help="float32 runs the JAX test's own dtype (default: the scenario's bf16)")
    p.add_argument("--role", default="single", choices=sorted(_ROLES),
                   help="anakin runs train_anakin_r2d2 (default: train_r2d2)")
    a = p.parse_args(args)
    with ThreadPoolExecutor(a.parallel) as pool:
        results = list(pool.map(lambda seed: run(seed, a.compute_dtype, a.role),
                                catch_bar._seeds(a.seeds)))
    for r in results:
        print(json.dumps(r), flush=True)
    evals = [r["eval_score_mean"] for r in results if r["rc"] == 0]
    print(json.dumps({"bar": catch_bar.R2D2_BAR, "evals": evals,
                      "eval_mean": sum(evals) / len(evals) if evals else None}), flush=True)
    return 1 if any(r["rc"] != 0 for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
