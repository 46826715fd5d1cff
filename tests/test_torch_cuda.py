"""The PyTorch port on a CUDA card: kernel K1 and the update through it.

Every test here needs the card and is marked ``cuda``; without one it
skips. The file imports no JAX, so it also runs where JAX is not
installed, without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from elevation_mapping_cupy_torch import MapConfig
from elevation_mapping_cupy_torch.mapper import ElevationMap
from elevation_mapping_cupy_torch.ops import cuda_scatter

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("exact", [(True, True), (False, False, True, True)])
def test_kernel_matches_plain_version(card, exact):
    """K1 against its plain version at the main path's map shape: integer
    streams bit for bit, value streams within 2e-4 (sums of O(1) here)."""
    rng = np.random.default_rng(0)
    n, n_cells = 131072, 202 * 202
    k = len(exact)
    idx = torch.from_numpy(rng.integers(0, n_cells, (1, n)).astype(np.int32)).to(card)
    mask = torch.from_numpy(rng.random((1, n)) > 0.1).to(card)
    vals = rng.standard_normal((1, k, n)).astype(np.float32)
    for s, e in enumerate(exact):
        if e:
            vals[:, s] = rng.integers(0, 3, (1, n))
    vals = torch.from_numpy(vals).to(card)
    before = cuda_scatter.KERNEL.launches
    got = cuda_scatter.scatter_add_streams(idx, mask, vals, n_cells)
    torch.cuda.synchronize()
    assert cuda_scatter.KERNEL.launches == before + 1
    want = cuda_scatter.scatter_add_streams_reference(idx, mask, vals, n_cells)
    for s, e in enumerate(exact):
        torch.testing.assert_close(got[:, s], want[:, s], rtol=0, atol=0 if e else 2e-4)


def test_wrapper_refuses_non_contiguous(card):
    vals = torch.ones((1, 4, 2), device=card).transpose(1, 2)  # (1, 2, 4), strided
    with pytest.raises(ValueError, match="contiguous"):
        cuda_scatter.scatter_add_streams(
            torch.zeros((1, 4), dtype=torch.int32, device=card),
            torch.ones((1, 4), dtype=torch.bool, device=card),
            vals,
            8,
        )


def test_update_on_card_matches_cpu(card):
    """Three updates of the smoke scene on a small map, on the card and on
    the CPU: three K1 launches each, and every layer within 1e-4."""
    cfg = MapConfig(resolution=0.1, map_length=4.0, max_ray_length=1.5, max_points=8192, raycast_mode="polar")
    gpu, cpu = ElevationMap(cfg), ElevationMap(cfg, device="cpu")
    rng = np.random.default_rng(3)
    before = cuda_scatter.KERNEL.launches
    for k in range(3):
        R, t, pos = chip_smoke.robot_pose(4 * k)
        pts = chip_smoke.scene_cloud(rng, 6000, R, t, r_max=2.5)
        for em in (gpu, cpu):
            em.move_to(pos, R)
            em.input_pointcloud(pts, ["x", "y", "z"], R, t, 0.0, 0.0)
    assert cuda_scatter.KERNEL.launches == before + 9
    names = ["elevation", "variance", "is_valid", "traversability", "upper_bound", "normal_z"]
    got, want = gpu.get_layers(names), cpu.get_layers(names)
    for name in names:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4, err_msg=name)
