"""The PyTorch port stands alone: rainbow_iqn_apex_tpu_torch and
chip_smoke.py import no JAX-family package and nothing of the JAX package
rainbow_iqn_apex_tpu, the whole port imports, serves, takes a learn step and
trains with those blocked, and nothing falls back to the CPU unless the
caller asks for it.
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
for name in ("jax", "jaxlib", "flax", "optax", "chex", "orbax", "rainbow_iqn_apex_tpu"):
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
