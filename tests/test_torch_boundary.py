"""The port's import boundary and its device rule.

``karpenter_core_tpu_torch``, ``chip_smoke.py`` and ``profile_solve.py``
must import neither JAX nor any module of the JAX package
``karpenter_core_tpu`` (the machine with the card has no JAX).  The port's
own name starts with the JAX package's, so the check compares the
top-level name exactly, never by prefix.  Entry points given no device must
raise when there is no CUDA card, never fall back to the CPU.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "karpenter_core_tpu_torch")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "profile_solve.py")]
    for root, _, files in os.walk(PORT):
        paths.extend(os.path.join(root, f) for f in files if f.endswith(".py"))
    return sorted(paths)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "karpenter_core_tpu")


def test_boundary_names_compare_exactly():
    assert _forbidden("jax.numpy") and _forbidden("karpenter_core_tpu.ops.solve")
    assert not _forbidden("karpenter_core_tpu_torch.ops.solve")


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad.extend(a.name for a in node.names if _forbidden(a.name))
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import karpenter_core_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'karpenter_core_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('karpenter_core_tpu_torch')]))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) > 20


def test_entry_points_without_a_card_raise(monkeypatch):
    from karpenter_core_tpu_torch import carry
    from karpenter_core_tpu_torch.cloudprovider import fake as fake_cp
    from karpenter_core_tpu_torch.solver.cuda import CudaSolver
    from karpenter_core_tpu_torch.testing import make_provisioner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    provider = fake_cp.FakeCloudProvider(fake_cp.instance_types(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaSolver(provider, [make_provisioner()])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        carry.tensors_from_numpy(
            {}, {}, (), device=None,
        )
    # the explicit request is honoured
    solver = CudaSolver(provider, [make_provisioner()], device="cpu")
    assert solver.device.type == "cpu"


def test_kernel_wrappers_take_the_plain_path_only_for_cpu_tensors():
    """A wrapper picks its plain twin because the tensor lies on the CPU, and
    counts no launch for it."""
    from karpenter_core_tpu_torch.kernels import fill, packbits

    before = (fill.launches, packbits.launches)
    out = fill.fill_by_priority(torch.tensor(3, dtype=torch.int32),
                                torch.ones(4, dtype=torch.int32),
                                torch.zeros(4, dtype=torch.int32))
    assert out.tolist() == [1, 1, 1, 0]
    assert packbits.pack_bool(torch.ones((2, 9), dtype=torch.bool)).numpy().tolist() == [
        [255, 128], [255, 128]]
    assert (fill.launches, packbits.launches) == before
    assert np.array_equal(packbits.unpack_bool(np.array([[255, 128]], np.uint8), 9),
                          np.ones((1, 9), bool))
