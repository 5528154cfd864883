"""Device-side class finishing (K15's twin) held against the JAX package's
``finish_class_planes_device`` and the port's own host padding, on the CPU.

The compact class rows of the port's ``prepare_host`` go through the
reference's jitted finisher, through the port's ``pad_planes`` with
``device_finish=True`` (``kernels/classfinish.py``'s twin on the CPU) and
through its host branch; every plane must be equal bit for bit, dtype and
shape included.  The encodes are those of tests/test_encode_delta.py's
device-finish case (16 pods x 6 types) and the headline mix at a small size,
whose topology groups do not fill their bucket (the group remap).
"""

import numpy as np
import pytest
import torch
import torch_history

from karpenter_core_tpu.ops import solve as jsolve
from karpenter_core_tpu_torch.cloudprovider import fake as tfake
from karpenter_core_tpu_torch.kernels import classfinish as k15
from karpenter_core_tpu_torch.models.columnar import PodIngest
from karpenter_core_tpu_torch.ops import solve as tsolve
from karpenter_core_tpu_torch.solver.cuda import CudaSolver
from karpenter_core_tpu_torch.testing import make_pod, make_provisioner, workloads

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


def _flat(x):
    if isinstance(x, tuple):
        return [leaf for item in x for leaf in _flat(item)]
    return [x]


def _encode(name):
    if name == "encode_delta":
        solver = CudaSolver(tfake.FakeCloudProvider(tfake.instance_types(6)),
                            [make_provisioner(name="default")], device="cpu")
        pods = [make_pod(requests={"cpu": "250m"}) for _ in range(16)]
    elif name == "host_ports":
        solver = CudaSolver(tfake.FakeCloudProvider(tfake.instance_types(9)),
                            [make_provisioner(name="default")], device="cpu")
        pods = [make_pod(requests={"cpu": "250m"}, host_ports=[8080 + i % 5])
                for i in range(20)]
    else:
        solver, pods = workloads.build_inputs(700, 50, 5, device="cpu")
    ingest = PodIngest()
    ingest.add_all(pods)
    return tsolve.prepare_host(solver.encode(ingest))


@pytest.mark.parametrize("name", ["encode_delta", "host_ports", "headline"])
def test_device_finish_matches_reference_and_host_padding(name):
    cls, sa, khb = _encode(name)
    host, _, _, _, _ = tsolve.pad_planes(cls, sa, khb)
    dev, sa_d, khb_d, _, _ = tsolve.pad_planes(cls, sa, khb, device_finish=True, device="cpu")
    sa_h = tsolve.pad_planes(cls, sa, khb)[1]
    g1_old = sa.grp_skew.shape[0]
    g1_new = tsolve.bucket(g1_old - 1, floor=4) + 1
    ref = jsolve.finish_class_planes_device(
        jsolve.ClassTensors(*(np.asarray(a) for a in cls)),
        c_new=tsolve.bucket(cls.count.shape[0]), k_new=tsolve.bucket(sa.valid.shape[0]),
        v_new=tsolve.bucket(sa.valid.shape[1] - 1), g1_old=g1_old, g1_new=g1_new,
        p_new=tsolve.bucket(cls.ports.shape[-1], floor=4))
    for field in tsolve.ClassTensors._fields:
        got = getattr(dev, field)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        got = got.numpy()
        for want in (np.asarray(getattr(host, field)), np.asarray(getattr(ref, field))):
            assert got.dtype == want.dtype and got.shape == want.shape, field
            np.testing.assert_array_equal(got, want, err_msg=field)
    # the statics pad on the host either way
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(_flat(tuple(sa_d)), _flat(tuple(sa_h))))
    assert khb_d == tsolve.pad_planes(cls, sa, khb)[2]
    if name == "headline":
        assert g1_new != g1_old  # the group remap ran
        assert (np.asarray(cls.groups) >= g1_old - 1).any()


def test_device_finish_solve_equals_host_padded_solve(monkeypatch):
    """``KC_ENCODE_DEVICE_FINISH=1`` through ``CudaSolver.prepare_encoded``:
    every SolveOutputs leaf equals the host-padded solve's."""
    solver, pods = workloads.build_inputs(700, 50, 5, device="cpu")
    ingest = PodIngest()
    ingest.add_all(pods)
    snapshot = solver.encode(ingest)
    host = solver.run_prepared(solver.prepare_encoded(snapshot))
    monkeypatch.setenv("KC_ENCODE_DEVICE_FINISH", "1")
    assert tsolve.encode_device_finish_enabled()
    dev = solver.run_prepared(solver.prepare_encoded(snapshot))
    for a, b in zip(_flat(tuple(host)), _flat(tuple(dev))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_extents_of_an_unpadded_plane_are_kept():
    """Extents equal to the compact rows' leave every plane as it is."""
    cls, sa, khb = _encode("encode_delta")
    c, k, w = cls.mask.shape
    ext = k15.Extents(c, k, w - 1, sa.grp_skew.shape[0], sa.grp_skew.shape[0],
                      cls.ports.shape[-1])
    compact = tsolve.ClassTensors(*(torch.as_tensor(np.asarray(a)) for a in cls))
    for got, want in zip(k15.finish_class_planes_plain(compact, ext), compact):
        assert torch.equal(got, want)
