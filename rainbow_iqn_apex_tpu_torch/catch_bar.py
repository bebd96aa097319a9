"""The catch learning bar of the port's trainers, over several seeds.

``chip_smoke.py`` holds each trainer to the JAX package's own bar: an
evaluation mean above 0.2 after 4,000 frames of ``toy:catch``
(``tests/test_train_integration.py``, ``tests/test_anakin.py``, at seed 7;
for ``--role apex`` the bar the JAX ``train_apex`` clears on the same
scenario, ``PERF.md``).  One such run is one draw from a spread of
outcomes, so ``chip_smoke.py`` takes the mean over seeds 7, 56, 57 and 58,
fixed before any run of them was read.  This module defines the scenarios
once (``argv``) and runs them over several seeds, a few processes at a
time, so that the spread can be read:

    python -m rainbow_iqn_apex_tpu_torch.catch_bar --role single --seeds 1-9 --parallel 4
    python -m rainbow_iqn_apex_tpu_torch.catch_bar --role apex --device-sampling false
    python -m rainbow_iqn_apex_tpu_torch.catch_bar --role apex --serve-quantize int8
    python -m rainbow_iqn_apex_tpu_torch.catch_bar --role r2d2 --seeds 3-6
    python -m rainbow_iqn_apex_tpu_torch.catch_bar --role r2d2_anakin --seeds 3-6
    python -m rainbow_iqn_apex_tpu_torch.catch_bar --role anakin_fused --seeds 7,53-55

The r2d2 scenario is the JAX package's own R2D2 catch run
(``tests/test_r2d2.py::test_r2d2_learns_catch``: LSTM 64, 20,000 frames) in
bf16 where the test runs fp32 (the card's K3 takes no other compute dtype;
``--compute-dtype float32`` gives the test's own), with its bar: eval above
0.3 and more than 100 learn steps.  The r2d2_anakin scenario is the same
run with ``--role anakin``: the sequence replay on the device.
``scripts/r2d2_catch_jax.py`` runs the JAX ``train_r2d2`` (or, with
``--role anakin``, ``train_anakin_r2d2``) on the same arguments.

The anakin_fused scenario is ``tests/test_anakin_fused.py::test_fused_learns_catch``
field for field (``jaxgame:catch`` on the device, K12 for the env, 8,000
frames) in bf16 where the test runs fp32, with its bar: eval above 0.5 and
more than 2,500 learn steps.

The apex scenario gives its frame budget as ``--t-max``, which the JAX
package's CLI reads too, so the same arguments run the reference:

    python train_agent_apex.py $(python -m rainbow_iqn_apex_tpu_torch.catch_bar \
        --role apex --seeds 3 --print-argv)

Each run is one ``rainbow_iqn_apex_tpu_torch.train`` process with cuDNN's
deterministic algorithms, as ``chip_smoke.py`` sets them, so a seed gives
the same run every time.  It prints one JSON line per run, then one with
the evaluation means and how many of them are at or below the bar.

``--serve-quantize int8`` (or ``fp8``) runs the apex scenario with quantized
actors: every publish after the warm-up's calibration draw is gated, with
``--quant-agreement-min 0`` unless asked otherwise, so it always ships the
quantized weights, and each run reports how many of its publishes did
(``quant_publishes``).  ``--quant-agreement-min 1.01`` makes every gate fail:
the bf16 trajectory with the calibration draw and the gates added.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

BAR = 0.2  # evaluation mean a run must exceed
MIN_LEARN_STEPS = 1500
FRAMES = 4000
R2D2_BAR = 0.3  # tests/test_r2d2.py::test_r2d2_learns_catch
R2D2_MIN_LEARN_STEPS = 100
R2D2_FRAMES = 20_000
FUSED_BAR = 0.5  # tests/test_anakin_fused.py::test_fused_learns_catch
FUSED_MIN_LEARN_STEPS = 2500
FUSED_FRAMES = 8000

_COMMON = ["--env-id", "toy:catch", "--compute-dtype", "bfloat16", "--frame-height", "80",
           "--frame-width", "80", "--history-length", "2", "--hidden-size", "128",
           "--num-cosines", "32", "--num-tau-samples", "8", "--num-tau-prime-samples", "8",
           "--batch-size", "32", "--learning-rate", "1e-3", "--multi-step", "3",
           "--gamma", "0.9", "--memory-capacity", "8192", "--learn-start", "512",
           "--frames-per-learn", "2", "--target-update-period", "200",
           "--num-envs-per-actor", "8", "--eval-interval", "0", "--checkpoint-interval", "0",
           "--eval-episodes", "40"]
_ROLE = {
    # tests/test_train_integration.py's _cfg (bf16: the card takes no other dtype)
    "single": ["--role", "single", "--num-quantile-samples", "8", "--adam-eps", "1e-8",
               "--metrics-interval", "200", "--max-frames", str(FRAMES)],
    # tests/test_anakin.py's test_anakin_learns_catch
    "anakin": ["--role", "anakin", "--num-quantile-samples", "4", "--metrics-interval", "100",
               "--max-frames", str(FRAMES)],
    # the single scenario as an Ape-X run: actors on weights published every
    # 100 learn steps, actor-side initial priorities; t_max is the budget
    "apex": ["--role", "apex", "--num-quantile-samples", "8", "--adam-eps", "1e-8",
             "--metrics-interval", "200", "--weight-publish-interval", "100",
             "--t-max", str(FRAMES)],
}
# tests/test_r2d2.py::test_r2d2_learns_catch, field for field but bf16 (its
# own arguments: none of _COMMON's)
_R2D2 = ["--role", "single", "--architecture", "r2d2", "--env-id", "toy:catch",
         "--compute-dtype", "bfloat16", "--history-length", "1", "--hidden-size", "64",
         "--lstm-size", "64", "--r2d2-burn-in", "2", "--r2d2-seq-len", "10",
         "--r2d2-overlap", "4", "--multi-step", "2", "--gamma", "0.9", "--batch-size", "16",
         "--learning-rate", "2e-3", "--target-update-period", "100",
         "--memory-capacity", "40000", "--learn-start", "2000", "--frames-per-learn", "1",
         "--num-envs-per-actor", "8", "--metrics-interval", "100",
         "--checkpoint-interval", "0", "--eval-interval", "0", "--eval-episodes", "30",
         "--max-frames", str(R2D2_FRAMES)]
# the same with the sequence replay on the device (train_anakin_r2d2)
_R2D2_ANAKIN = ["--role", "anakin", *_R2D2[2:]]
_R2D2_ROLES = {"r2d2": _R2D2, "r2d2_anakin": _R2D2_ANAKIN}
# tests/test_anakin_fused.py::test_fused_learns_catch, field for field but
# bf16: the fully fused anakin with the env on the device
_ANAKIN_FUSED = ["--role", "anakin", "--env-id", "jaxgame:catch", "--compute-dtype", "bfloat16",
                 "--history-length", "2", "--hidden-size", "128", "--num-cosines", "32",
                 "--num-tau-samples", "8", "--num-tau-prime-samples", "8",
                 "--num-quantile-samples", "4", "--batch-size", "32", "--learning-rate", "1e-3",
                 "--multi-step", "3", "--gamma", "0.9", "--memory-capacity", "8192",
                 "--learn-start", "512", "--frames-per-learn", "2",
                 "--target-update-period", "200", "--num-envs-per-actor", "8",
                 "--anakin-segment-ticks", "32", "--learner-devices", "1",
                 "--metrics-interval", "100", "--eval-interval", "0",
                 "--checkpoint-interval", "0", "--eval-episodes", "40",
                 "--max-frames", str(FUSED_FRAMES)]
_OWN_ARGS = {**_R2D2_ROLES, "anakin_fused": _ANAKIN_FUSED}
ROLES = (*_ROLE, *_OWN_ARGS)
BARS = {"r2d2": R2D2_BAR, "r2d2_anakin": R2D2_BAR, "anakin_fused": FUSED_BAR}
MIN_STEPS = {"r2d2": R2D2_MIN_LEARN_STEPS, "r2d2_anakin": R2D2_MIN_LEARN_STEPS,
             "anakin_fused": FUSED_MIN_LEARN_STEPS}

# two CPU threads a run: the runs go to the card, and several trainer
# processes share the host's cores
_BOOT = ("import sys, torch; torch.backends.cudnn.deterministic = True; "
         "torch.backends.cudnn.benchmark = False; torch.set_num_threads(2); "
         "from rainbow_iqn_apex_tpu_torch.train import main; main(sys.argv[1:])")


def argv(role: str, seed: int, workdir: str, device_sampling: bool = True,
         serve_quantize: str = "off", quant_agreement_min: float = 0.0,
         compute_dtype: str = "") -> List[str]:
    """The trainer's CLI arguments of ``role``'s catch scenario at ``seed``,
    writing results and checkpoints under ``workdir``; ``device_sampling``
    and ``serve_quantize`` are the apex scenario's sampling mode and actor
    weights; ``compute_dtype`` overrides the r2d2 and anakin_fused
    scenarios' bf16."""
    if role in _OWN_ARGS:
        dtype = ["--compute-dtype", compute_dtype] if compute_dtype else []
        return [*_OWN_ARGS[role], *dtype, "--seed", str(seed),
                "--results-dir", os.path.join(workdir, "results"),
                "--checkpoint-dir", os.path.join(workdir, "ckpt")]
    extra = []
    if role == "apex":
        extra = ["--device-sampling", str(device_sampling).lower()]
        if serve_quantize != "off":
            extra += ["--serve-quantize", serve_quantize,
                      "--quant-agreement-min", repr(float(quant_agreement_min))]
    return [*_COMMON, *_ROLE[role], *extra, "--seed", str(seed),
            "--results-dir", os.path.join(workdir, "results"),
            "--checkpoint-dir", os.path.join(workdir, "ckpt")]


def quant_publishes(results_dir: str) -> int:
    """How many ``publish`` rows under ``results_dir`` shipped quantized
    weights (the JAX package writes the same rows)."""
    count = 0
    for run_id in sorted(os.listdir(results_dir)) if os.path.isdir(results_dir) else ():
        path = os.path.join(results_dir, run_id, "metrics.jsonl")
        if os.path.exists(path):
            with open(path) as f:
                rows = [json.loads(line) for line in f if line.strip()]
            count += sum(r.get("kind") == "publish" and r.get("mode") in ("int8", "fp8")
                         for r in rows)
    return count


def run(role: str, seed: int, device: str, device_sampling: bool = True,
        serve_quantize: str = "off", quant_agreement_min: float = 0.0) -> Dict:
    """One scenario run in its own process; its summary."""
    with tempfile.TemporaryDirectory(prefix="catch_bar_") as tmp:
        proc = subprocess.run(
            [sys.executable, "-c", _BOOT,
             *argv(role, seed, tmp, device_sampling, serve_quantize, quant_agreement_min),
             "--device", device],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        published = quant_publishes(os.path.join(tmp, "results"))
    out: Dict = {"role": role, "seed": seed, "rc": proc.returncode}
    if proc.returncode != 0:
        out["error"] = proc.stderr[-2000:]
        return out
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    out.update(eval_score_mean=summary["eval_score_mean"],
               train_return_mean=summary["train_return_mean"],
               learn_steps=summary["learn_steps"])
    if serve_quantize != "off":
        out["quant_publishes"] = published
    return out


def _seeds(text: str) -> List[int]:
    seeds: List[int] = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        seeds += list(range(int(lo), int(hi or lo) + 1))
    return seeds


def main(args=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--role", choices=sorted(ROLES), action="append",
                   help="scenario (repeatable; default all but the r2d2 and anakin_fused ones)")
    p.add_argument("--seeds", default="1-9", help="e.g. 1-9 or 7,7,7")
    p.add_argument("--parallel", type=int, default=4, help="runs at a time")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--device-sampling", default="true", choices=("true", "false"),
                   help="the apex scenario's sampling mode (default true)")
    p.add_argument("--serve-quantize", default="off", choices=("off", "int8", "fp8"),
                   help="the apex scenario's actor weights (default off)")
    p.add_argument("--quant-agreement-min", type=float, default=0.0,
                   help="the gate's threshold with --serve-quantize (default 0)")
    p.add_argument("--print-argv", action="store_true",
                   help="print each run's trainer arguments (results under ./catch_bar) "
                        "and run nothing")
    a = p.parse_args(args)
    sampling = a.device_sampling == "true"
    jobs = [(role, seed) for role in (a.role or sorted(_ROLE)) for seed in _seeds(a.seeds)]
    if a.print_argv:
        for role, seed in jobs:
            print(" ".join(argv(role, seed, os.path.join("catch_bar", f"{role}{seed}"),
                                sampling, a.serve_quantize, a.quant_agreement_min)))
        return 0

    def one(job):
        result = run(*job, device=a.device, device_sampling=sampling,
                     serve_quantize=a.serve_quantize,
                     quant_agreement_min=a.quant_agreement_min)
        print(json.dumps(result), flush=True)
        return result

    with ThreadPoolExecutor(a.parallel) as pool:
        results = list(pool.map(one, jobs))
    failed_runs = any(r["rc"] != 0 for r in results)
    for role in sorted({r["role"] for r in results}):
        evals = [r["eval_score_mean"] for r in results if r["role"] == role and r["rc"] == 0]
        bar = BARS.get(role, BAR)
        print(json.dumps({"role": role, "bar": bar, "evals": evals,
                          "eval_mean": sum(evals) / len(evals) if evals else None,
                          "at_or_below_bar": sum(e <= bar for e in evals)}), flush=True)
    return 1 if failed_runs else 0


if __name__ == "__main__":
    sys.exit(main())
