"""The port's native replay core loader (rainbow_iqn_apex_tpu_torch/replay/
native.py): built once however many processes ask for it at the same time,
loaded natively by every one of them, and never replaced silently by the
NumPy path when a compiler is present.

Processes that start together (pytest-xdist workers, actor processes) all
find a fresh checkout's library missing.  The loader builds under an
exclusive lock on a file beside the library, g++ writes a temporary name,
and ``os.replace`` moves the finished file into place, so no process loads
a partial file.  The NumPy path draws other indices than the native one
(``tests/test_torch_train.py::test_replay_samples_what_the_jax_package_samples``
compares both against the JAX package), so it is taken only where no g++
exists; a failed build raises with the compiler's stderr.
"""

import os
import shutil
import subprocess
import sys
import time

import pytest

from rainbow_iqn_apex_tpu_torch.replay import native

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")

_WORKER = r"""
import os, sys, time
import rainbow_iqn_apex_tpu_torch.replay.native as native
build, go = sys.argv[1], sys.argv[2]
native._SO = os.path.join(build, os.path.basename(native._SO))
print("ready", flush=True)
while not os.path.exists(go):
    time.sleep(0.005)
lib = native._build_and_load()
print("native" if lib is not None and native.native_available() else "numpy", flush=True)
"""

PROCESSES = 6


def test_concurrent_builds_load_natively_in_every_process(tmp_path):
    """Six processes ask at the same moment for a library that a fresh build
    directory lacks: each one loads it natively, one file is built, and no
    temporary file is left behind."""
    build, go = tmp_path / "build", tmp_path / "go"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(build), str(go)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(PROCESSES)]
    try:
        for p in procs:  # every process imported the loader before any build starts
            assert p.stdout.readline().strip() == "ready"
        go.touch()
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "native", err
    libs = sorted(os.listdir(build))
    assert libs == [os.path.basename(native._SO), os.path.basename(native._SO) + ".lock"]


def _fresh_loader(monkeypatch, so):
    monkeypatch.setattr(native, "_SO", str(so))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("int st_set( {\n")
    _fresh_loader(monkeypatch, tmp_path / "build" / "_replay_bad.so")
    monkeypatch.setattr(native, "_SRCS", (str(bad),))
    with pytest.raises(RuntimeError, match="bad.cc"):
        native.native_available()
    assert not os.path.exists(native._SO)
    assert [f for f in os.listdir(tmp_path / "build") if f.endswith(".tmp")] == []


def test_the_numpy_path_only_where_no_compiler_exists(tmp_path, monkeypatch):
    _fresh_loader(monkeypatch, tmp_path / "build" / "_replay_none.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.native_available()
    assert not os.path.exists(tmp_path / "build")


def test_a_built_library_is_loaded_without_a_compile(tmp_path, monkeypatch):
    """Once the library exists (the content hash is in its name), a process
    loads that file and compiles nothing."""
    _fresh_loader(monkeypatch, tmp_path / "build" / os.path.basename(native._SO))
    native._build()
    built = os.stat(native._SO).st_mtime_ns
    time.sleep(0.01)
    monkeypatch.setattr(native.subprocess, "run", lambda *a, **k: pytest.fail("rebuilt"))
    assert native.native_available()
    assert os.stat(native._SO).st_mtime_ns == built
