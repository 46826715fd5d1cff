"""The polar cube's scans: dispatch and the kernel's argument checks, on the CPU.

The kernel itself (``csrc/polar_scan.cu``) runs only on a card
(``tests/test_torch_cuda.py``); these tests need neither a card nor
``nvcc``. The polar cleanup around the plain version is held to the JAX
package in ``tests/test_torch_ops.py`` and ``tests/test_torch_parallel.py``.
"""

import os
import re

import numpy as np
import pytest
import torch

from elevation_mapping_cupy_torch import MapConfig, kernels
from elevation_mapping_cupy_torch.mapper import ElevationMap
from elevation_mapping_cupy_torch.nn.traversability import default_weights
from elevation_mapping_cupy_torch.ops import raycast
from elevation_mapping_cupy_torch.parallel import batched_update, init_batch


def _cube(b=2, A=8, R=5, S=6, seed=0, dtype=torch.float32):
    """A (b, 2, A, R, S) cube as K1 leaves it: whole ray counts and sums of
    1/length, most bins empty."""
    g = torch.Generator().manual_seed(seed)
    hit = torch.rand((b, 1, A, R, S), generator=g) < 0.3
    cnt = torch.randint(1, 40, (b, 1, A, R, S), generator=g).float() * hit
    inv = cnt * (0.1 + torch.rand((b, 1, A, R, S), generator=g))
    return torch.cat([cnt, inv], dim=1).to(dtype)


def _inline(cubes):
    """The scans as the polar cleanup wrote them inline before they became a
    function."""
    packed = torch.cat([torch.flip(torch.cumsum(torch.flip(cubes[:, i], [2]), dim=2), [2]) for i in range(2)],
                       dim=-1)
    return torch.cumsum(packed, dim=1)


def _bad_cube(kind):
    """(a cube that polar_scan's kernel must refuse, the error it raises)."""
    cubes = _cube()
    if kind == "four_dims":
        return cubes[:, 0], ValueError
    if kind == "three_streams":
        return torch.cat([cubes, cubes[:, :1]], dim=1), ValueError
    if kind == "six_dims":
        return cubes[None], ValueError
    if kind == "float64":
        return cubes.double(), TypeError
    if kind == "int32":
        return cubes.int(), TypeError
    if kind == "strided":
        return cubes.transpose(-1, -2).contiguous().transpose(-1, -2), ValueError
    if kind == "cpu_tensors":
        return cubes, ValueError
    raise AssertionError(kind)


SHARED_KINDS = ["four_dims", "three_streams", "six_dims", "float64", "int32"]


@pytest.mark.parametrize("kind", SHARED_KINDS + ["strided", "cpu_tensors"])
def test_kernel_refuses_before_any_build(monkeypatch, kind):
    """The kernel's launch refuses what it does not take, CPU tensors last
    of all, without building the kernel or counting a launch."""

    def no_build():
        raise AssertionError("the kernel was built")

    monkeypatch.setattr(raycast.SCAN_KERNEL, "load", no_build)
    cubes, error = _bad_cube(kind)
    before = raycast.SCAN_KERNEL.launches
    with pytest.raises(error):
        raycast.launch_polar_scan(cubes)
    assert raycast.SCAN_KERNEL.launches == before


@pytest.mark.parametrize("kind", SHARED_KINDS)
def test_plain_version_refuses_the_same_shapes_and_types(kind):
    cubes, error = _bad_cube(kind)
    with pytest.raises(error):
        raycast.polar_scan(cubes)
    with pytest.raises(error):
        raycast._polar_scan(cubes)


@pytest.mark.parametrize("shape", [(1, 8, 5, 6), (3, 16, 9, 37), (2, 4, 1, 1)])
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(monkeypatch, shape):
    monkeypatch.setattr(raycast, "launch_polar_scan", None)  # never reached on the CPU
    b, A, R, S = shape
    cubes = _cube(b, A, R, S, seed=sum(shape))
    before = raycast.SCAN_KERNEL.launches
    got = raycast.polar_scan(cubes)
    assert got.shape == (b, A, R, 2 * S)
    assert torch.equal(got, raycast._polar_scan(cubes))
    assert raycast.SCAN_KERNEL.launches == before
    assert raycast.SCAN_KERNEL.source == "polar_scan.cu"
    assert kernels.registered_kernels()[raycast.SCAN_KERNEL.name] is raycast.SCAN_KERNEL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_version_equals_the_inline_scans(seed):
    """``_polar_scan`` is the inline flip/cumsum/flip/cat/cumsum, bit for bit,
    and holds the sums it stands for (float64 reference, float32 rounding)."""
    cubes = _cube(3, 16, 9, 37, seed=seed)
    got = raycast._polar_scan(cubes)
    assert torch.equal(got, _inline(cubes))
    c = cubes.double().numpy()
    suffix = np.flip(np.cumsum(np.flip(c, 3), 3), 3)                # along R, from the far end
    want = np.cumsum(np.concatenate([suffix[:, 0], suffix[:, 1]], -1), 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_empty_cube():
    for cubes in (torch.zeros((0, 2, 8, 5, 6)), torch.zeros((2, 2, 0, 5, 6))):
        assert raycast.polar_scan(cubes).shape == (cubes.shape[0], cubes.shape[2], 5, 12)


def test_other_devices_are_refused():
    with pytest.raises(ValueError, match="cuda or cpu"):
        raycast.polar_scan(_cube().to("meta"))


def test_entry_point_takes_the_wrappers_arguments():
    """The C entry point's parameters are SCAN_KERNEL's argument types, the
    stream last."""
    with open(os.path.join(kernels.CSRC_DIR, "polar_scan.cu")) as f:
        src = f.read()
    params = re.search(r'extern "C" int polar_scan\((.*?)\)', src, re.S).group(1).split(",")
    types = [p.strip().rsplit(" ", 1)[0] for p in params]
    assert types == ["const void*", "void*", "int32_t", "int32_t", "int32_t", "int32_t", "void*"]
    assert len(raycast.SCAN_KERNEL.argtypes) == len(types)


def test_polar_update_scans_its_cube_once(monkeypatch):
    """Every polar cleanup, one map or a batch, hands its whole cube to
    ``polar_scan`` once; the exact path never does."""
    calls = []
    real = raycast.polar_scan

    def spy(cubes):
        calls.append(tuple(cubes.shape))
        return real(cubes)

    monkeypatch.setattr(raycast, "polar_scan", spy)
    torch.manual_seed(0)
    cfg = MapConfig(resolution=0.1, map_length=2.0, max_ray_length=1.0, raycast_elevation_bins=12,
                    raycast_azimuth_bins=16, max_points=512)
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-0.9, 0.9, (400, 2)), rng.uniform(-0.2, 0.3, (400, 1))], 1).astype(np.float32)
    R, t = np.eye(3, dtype=np.float32), np.array([0.0, 0.0, 0.5], np.float32)
    cube = (2, 16, cfg.n_ray_steps + 2, 12)
    for mode, want in (("polar", 2), ("exact", 0)):
        calls.clear()
        em = ElevationMap(cfg.replace(raycast_mode=mode), device="cpu")
        for _ in range(2):
            em.input_pointcloud(pts, ["x", "y", "z"], R, t, 0.0, 0.0)
        assert calls == [(1,) + cube] * want
    calls.clear()
    b = 3
    cfg = cfg.replace(raycast_mode="polar")
    states = init_batch(cfg, b, "cpu")
    z = torch.zeros(b)
    points = torch.from_numpy(pts).expand(b, -1, -1).contiguous()
    mask = torch.ones(points.shape[:2], dtype=torch.bool)
    batched_update(states, points, mask, torch.eye(3).expand(b, 3, 3).contiguous(),
                   torch.from_numpy(t).expand(b, 3).contiguous(), z, z, default_weights(), cfg)
    assert calls == [(b,) + cube]
