"""Build and load the hand-written CUDA kernels.

Each source in ``karpenter_core_tpu_torch/csrc/`` is compiled by ``nvcc``
into its own shared library with a plain C interface and loaded with
``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

No ``--use_fast_math``: the capacity kernel's divide must round to nearest
exactly as the reference does.  Libraries land in
``karpenter_core_tpu_torch/_build/`` (git-ignored), named by a hash of the
source, so an edited source rebuilds and a stale library is never loaded.
``build_all`` starts one ``nvcc`` per source at once and waits for all of
them.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("it_capacity", "fill_priority", "req_merge", "pack_bool")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def _start(name: str) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", out + ".tmp", os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
    out = _lib_path(name)
    os.replace(out + ".tmp", out)


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Compile every kernel source that has no current library, one ``nvcc``
    per source, all started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        procs = {name: _start(name) for name in names}
        for name, proc in procs.items():
            _finish(name, proc)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def check_input(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of the given type, shape and
    device (``None`` entries in ``shape`` match any extent)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if len(t.shape) != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
