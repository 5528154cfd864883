"""Build and load the hand-written CUDA kernels.

Each source in ``karpenter_core_tpu_torch/csrc/`` is compiled by ``nvcc``
into its own shared library with a plain C interface and loaded with
``ctypes`` (a source may include the shared headers ``csrc/*.cuh``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

No ``--use_fast_math``: the capacity kernels' divides must round to nearest
exactly as the reference does.  nvcc still contracts ``a * b + c`` into an
FMA by default, so the sources whose float arithmetic must round as the
reference's does (K6's ``used + a * req``, K7's water-fill, K10's eviction
free, K13's scores, the relax family's K14-K18, K23's slot commit) spell it
with the ``__f*_rn`` intrinsics.  Libraries land in
``karpenter_core_tpu_torch/_build/`` (git-ignored), named by a hash of the
source and the headers, so an edited source or header rebuilds and a stale
library is never loaded.
``build_all`` starts one ``nvcc`` per source at once and waits for all of
them.  Nothing here runs at import time.

The launch path is kept lean, because a wrapper's host time shows in a
call's wall time whenever it is longer than the kernel's: ``function``
binds each C entry point once, with its argument and result types, and
caches it; ``stream`` reads the current stream's raw handle; and
``check_input`` tests the common case with a few attribute reads before it
spells out what is wrong.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("it_capacity", "fill_priority", "req_merge", "pack_bool", "existing_intake",
           "existing_phase", "spread_quota", "sweep_lanes", "lane_finish", "repair_free",
           "repair_gather", "repair_scatter", "select_offerings", "class_finish", "relax_cost",
           "simplex_pgd", "relax_round", "relax_materialize", "perturb_avail",
           "replica_finish", "slot_commit")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], Any] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, of every shared
    header in ``csrc/`` and of the flags."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [os.path.join(CSRC, f"{name}.cu")] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


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


def function(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
    """The C entry point ``symbol`` of kernel source ``name``, its
    ``argtypes`` and ``restype`` set once and the binding cached (the
    library is built and loaded on first use)."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[(name, symbol)] = fn
    return fn


def stream(dev: torch.device) -> int:
    """The raw handle of ``dev``'s current CUDA stream."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(index).cuda_stream
    return raw(index)


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def check_input(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of the given type, shape and
    device (``None`` entries in ``shape`` match any extent)."""
    if (t.dtype is dtype and t.shape == shape and t.is_contiguous()
            and t.get_device() == device.index):
        return  # the common case: a CUDA tensor exactly as asked
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
