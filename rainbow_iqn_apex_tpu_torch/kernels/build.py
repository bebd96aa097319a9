"""Build and load the port's CUDA kernels: nvcc by hand, bound with ctypes.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process (all started together) and the objects are linked into one shared
library with a plain C interface.  The library is built at first use into
``_build/`` beside the package (listed in ``.gitignore``), under a name that
hashes the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs at import time: this
module imports on a machine without ``nvcc`` or a card, where only the plain
twins run.

``launches`` counts kernel launches by kernel name.  A wrapper adds one
right after its kernel launched, and nowhere else.  ``folded`` counts the
runs of a kernel's work folded into another kernel's launch (K6 in K1's
weighted launch, K6f's queue in K5f's), which count as that launch only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
SOURCES = ("tau_embed.cu", "noisy_linear.cu", "dueling_head.cu", "quantile_huber.cu",
           "tau_embed_bwd.cu", "noisy_linear_bwd.cu", "dueling_head_bwd.cu", "replay_draw.cu",
           "replay_writeback.cu", "replay_append.cu", "replay_assemble.cu", "frontier_draw.cu",
           "frontier_writeback.cu", "quantize.cu", "noisy_linear_q.cu", "dequantize.cu", "lstm.cu",
           "r2d2_td.cu", "seq_stack.cu", "seq_append.cu", "seq_draw.cu", "seq_assemble.cu",
           "device_games.cu")
HEADERS = ("common.cuh", "hopper.cuh", "threefry.cuh", "writeback.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches: Dict[str, int] = {
    "K1_quantile_huber": 0,
    "K2_tau_embed": 0,
    "K2_tau_embed_bwd": 0,
    "K3_noisy_linear": 0,
    "K3_noisy_linear_bwd": 0,
    "K4_dueling_head": 0,
    "K4_dueling_head_bwd": 0,
    "K2g_tau_embed_game": 0,
    "K2g_tau_embed_game_bwd": 0,
    "K4m_dueling_head_mask": 0,
    "K4l_dueling_head_logp": 0,
    "K5_replay_draw": 0,
    "K6_replay_writeback": 0,
    "K7_replay_append": 0,
    "K8_replay_assemble": 0,
    "K5f_frontier_draw": 0,
    "K6f_frontier_writeback": 0,
    "K10q_quantize": 0,
    "K10g_noisy_linear_q": 0,
    "K10d_dequantize": 0,
    "K9_lstm": 0,
    "K9_lstm_bwd": 0,
    "K11_r2d2_td": 0,
    "K8s_seq_stack": 0,
    "K7s_seq_append": 0,
    "K5s_seq_draw": 0,
    "K8s_seq_assemble": 0,
    "K6s_seq_writeback": 0,
    "K12_device_games": 0,
}

# kernel name -> runs inside another kernel's launch (the host of the fold)
folded: Dict[str, int] = {
    "K6_replay_writeback": 0,  # in K1_quantile_huber's weighted launch
    "K6f_frontier_writeback": 0,  # in K5f_frontier_draw's first launch
}
FOLDED_INTO = {"K6_replay_writeback": "K1_quantile_huber",
               "K6f_frontier_writeback": "K5f_frontier_draw"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log: List[str] = []  # nvcc output of the build this process ran


def reset_launches() -> None:
    for counts in (launches, folded):
        for name in counts:
            counts[name] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the port's CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*SOURCES, *HEADERS):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libport_kernels_{_digest()}.so")


def build() -> str:
    """Compile and link the kernels unless this exact build exists; returns
    the library's path.  Raises RuntimeError with nvcc's output on failure."""
    target = library_path()
    if os.path.exists(target):
        return target
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR)
    try:
        objects = [os.path.join(work, src.replace(".cu", ".o")) for src in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objects)
        ]
        outputs = [p.communicate()[0] for p in procs]
        build_log[:] = outputs
        failed = [src for src, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(outputs))
        linked = os.path.join(work, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", "-o", linked, *objects],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(linked, target)  # atomic: a concurrent build loads either
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.port_error_string.argtypes = [ctypes.c_int]
            lib.port_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_launch(name: str, code: int, fold: Optional[str] = None) -> None:
    """Raise if a C entry reported a launch error; else count the launch
    (and, with ``fold``, one run of that kernel's work inside it)."""
    if code != 0:
        msg = library().port_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")
    launches[name] += 1
    if fold is not None:
        folded[fold] += 1


def stream_of(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(tensor: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if tensor is None else tensor.data_ptr())
