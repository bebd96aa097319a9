"""The PyTorch port stands alone: rainbow_iqn_apex_tpu_torch and
chip_smoke.py import no JAX-family package and nothing of the JAX package
rainbow_iqn_apex_tpu, the whole port imports, serves, takes a learn step,
trains, takes a fused Anakin step (device replay), runs a short Ape-X
loop with device sampling, serves an int8 and an fp8 request, runs a
short Ape-X loop with int8 actors, takes an R2D2 learn step and trains
R2D2 briefly with those (and ``ml_dtypes``) blocked,
and nothing falls back to the CPU unless the caller asks for it.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "rainbow_iqn_apex_tpu_torch")
BANNED_TOP = {"jax", "jaxlib", "flax", "optax", "chex", "orbax"}
JAX_PACKAGE = "rainbow_iqn_apex_tpu"


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in BANNED_TOP or module == JAX_PACKAGE or module.startswith(JAX_PACKAGE + ".")


def test_banned_predicate_minds_the_prefix():
    assert _banned("jax.numpy") and _banned("orbax.checkpoint")
    assert _banned("rainbow_iqn_apex_tpu") and _banned("rainbow_iqn_apex_tpu.config")
    assert not _banned("rainbow_iqn_apex_tpu_torch")
    assert not _banned("rainbow_iqn_apex_tpu_torch.kernels.build")
    assert not _banned("jaxtyping")


def test_port_sources_import_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    offenders = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}"
                          for n in names if _banned(n)]
    assert not offenders, offenders


_BLOCKED_RUN = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "chex", "orbax", "ml_dtypes",
             "rainbow_iqn_apex_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
import rainbow_iqn_apex_tpu_torch as port
mods = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # noqa: F401
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.models import init_params
from rainbow_iqn_apex_tpu_torch.serving import PolicyServer
cfg = Config(compute_dtype="float32", frame_height=44, frame_width=44, history_length=2,
             hidden_size=32, num_cosines=8, num_quantile_samples=4, serve_batch_buckets="2")
server = PolicyServer(cfg, 3, init_params(cfg, 3, seed=0), device="cpu").start()
action, q = server.act_values(np.zeros((44, 44, 2), np.uint8))
server.stop()
assert 0 <= action < 3 and q.shape == (3,)

import tempfile, torch
torch.set_num_threads(2)
from rainbow_iqn_apex_tpu_torch.ops.learn import Batch, build_learn_step, init_train_state
from rainbow_iqn_apex_tpu_torch.train import train
cfg = cfg.replace(num_tau_samples=4, num_tau_prime_samples=4, batch_size=2)
state = init_train_state(cfg, 3, seed=0, device="cpu")
u8 = torch.zeros((2, 44, 44, 2), dtype=torch.uint8)
batch = Batch(obs=u8, action=torch.tensor([0, 2], dtype=torch.int32), reward=torch.ones(2),
              next_obs=u8, discount=torch.full((2,), 0.9), weight=torch.ones(2))
state, info = build_learn_step(cfg, 3)(state, batch, torch.Generator().manual_seed(0))
assert state.step == 1 and bool(info["finite"])
with tempfile.TemporaryDirectory() as tmp:
    summary = train(cfg.replace(env_id="toy:catch", frame_height=80, frame_width=80,
                                learn_start=64, batch_size=8, memory_capacity=512,
                                num_envs_per_actor=4, eval_episodes=1, stall_timeout_s=0.0,
                                results_dir=tmp + "/r", checkpoint_dir=tmp + "/c"),
                    max_frames=200, device="cpu")
assert summary["frames"] == 200 and summary["learn_steps"] > 0

from rainbow_iqn_apex_tpu_torch.replay.device import DeviceReplay, build_device_learn
replay = DeviceReplay(2, 24, (44, 44), history=2, n_step=3, device="cpu")
ds = replay.init_state()
for t in range(30):
    replay.append(ds, torch.full((2, 44, 44), t, dtype=torch.uint8),
                  torch.tensor([t % 3, 1], dtype=torch.int32), torch.ones(2),
                  torch.tensor([t % 7 == 6, False]), torch.zeros(2, dtype=torch.bool))
state = init_train_state(cfg, 3, seed=0, device="cpu")
before = ds.priority.clone()
state, ds, info = build_device_learn(cfg, 3, replay)(state, ds, torch.Generator().manual_seed(0), 0.5)
assert state.step == 1 and bool(info["finite"]) and not torch.equal(before, ds.priority)

from rainbow_iqn_apex_tpu_torch.parallel.apex import train_apex
with tempfile.TemporaryDirectory() as tmp:
    summary = train_apex(cfg.replace(env_id="toy:catch", frame_height=80, frame_width=80,
                                     role="apex", device_sampling=True, learn_start=64,
                                     batch_size=8, memory_capacity=512, num_envs_per_actor=4,
                                     eval_episodes=1, stall_timeout_s=0.0,
                                     results_dir=tmp + "/r", checkpoint_dir=tmp + "/c"),
                         max_frames=160, device="cpu")
assert summary["frames"] == 160 and summary["learn_steps"] > 0

qcfg = cfg.replace(serve_batch_buckets="2", quant_agreement_min=0.0, quant_calib_batch=2)
for mode in ("int8", "fp8"):
    server = PolicyServer(qcfg.replace(serve_quantize=mode), 3, init_params(cfg, 3, seed=0),
                          device="cpu").start()
    action = server.act(np.zeros((44, 44, 2), np.uint8))
    assert 0 <= action < 3 and server.stats()["quant_active"], mode
    server.stop()
import json
with tempfile.TemporaryDirectory() as tmp:
    summary = train_apex(qcfg.replace(env_id="toy:catch", frame_height=80, frame_width=80,
                                      role="apex", serve_quantize="int8", learn_start=64,
                                      batch_size=8, memory_capacity=512, num_envs_per_actor=4,
                                      weight_publish_interval=10, eval_episodes=1,
                                      stall_timeout_s=0.0, results_dir=tmp + "/r",
                                      checkpoint_dir=tmp + "/c"),
                         max_frames=120, device="cpu")
    with open(tmp + "/r/run0/metrics.jsonl") as f:
        modes = [r.get("mode") for r in map(json.loads, f) if r["kind"] == "publish"]
assert summary["learn_steps"] > 0 and modes and set(modes) == {"int8"}, modes

from rainbow_iqn_apex_tpu_torch.ops.r2d2 import (SequenceBatch, build_r2d2_learn_step,
                                                 init_r2d2_state)
rcfg = cfg.replace(architecture="r2d2", lstm_size=16, r2d2_burn_in=2, r2d2_seq_len=4,
                   r2d2_overlap=2, multi_step=2)
rstate = init_r2d2_state(rcfg, 3, 0, (44, 44), device="cpu")
rb = SequenceBatch(obs=torch.zeros((2, 6, 44, 44, 1), dtype=torch.uint8),
                   action=torch.ones((2, 6), dtype=torch.int32), reward=torch.ones((2, 6)),
                   done=torch.zeros((2, 6), dtype=torch.bool),
                   valid=torch.ones((2, 6), dtype=torch.bool), init_c=torch.zeros((2, 16)),
                   init_h=torch.zeros((2, 16)), weight=torch.ones(2))
rstate, info = build_r2d2_learn_step(rcfg, 3)(rstate, rb, torch.Generator().manual_seed(0))
assert rstate.step == 1 and bool(info["finite"])
with tempfile.TemporaryDirectory() as tmp:
    summary = train(rcfg.replace(env_id="toy:catch", history_length=1, learn_start=48,
                                 batch_size=4, memory_capacity=512, num_envs_per_actor=4,
                                 eval_episodes=1, results_dir=tmp + "/r",
                                 checkpoint_dir=tmp + "/c"),
                    max_frames=160, device="cpu")
assert summary["frames"] == 160 and summary["learn_steps"] > 0
print("OK", len(mods))
"""


def test_port_imports_and_serves_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                         capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.startswith("OK")
    assert int(out.stdout.split()[1]) >= 40  # every port module was imported


def test_engine_raises_without_cuda_and_without_a_device(monkeypatch):
    from rainbow_iqn_apex_tpu_torch.config import Config
    from rainbow_iqn_apex_tpu_torch.models import init_params
    from rainbow_iqn_apex_tpu_torch.ops import resolve_device
    from rainbow_iqn_apex_tpu_torch.serving import InferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(compute_dtype="float32", frame_height=44, frame_width=44,
                 history_length=2, hidden_size=32, num_cosines=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(cfg, 3, init_params(cfg, 3, seed=0))
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, os.path.join(cwd, "chip_smoke.py")], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_in_a_directory_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
