"""The PyTorch port on a CUDA card: kernels K1 and K2 and the updates through them.

Every test here needs the card and is marked ``cuda``; without one it
skips. The file imports no JAX, so it also runs where JAX is not
installed, without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from elevation_mapping_cupy_torch import MapConfig, core
from elevation_mapping_cupy_torch.mapper import ElevationMap
from elevation_mapping_cupy_torch.ops import cuda_march, cuda_scatter

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


SMALL_KW = dict(resolution=0.1, map_length=4.0, max_ray_length=1.5, max_points=8192)


def _aged_map(cfg, n_points: int):
    """A map built by a few polar updates on the card, then aged past the
    recency gate so that the march can clean cells up."""
    em = ElevationMap(cfg.replace(raycast_mode="polar"))
    rng = np.random.default_rng(8)
    for k in range(3):
        R, t, pos = chip_smoke.robot_pose(k)
        em.move_to(pos, R)
        em.input_pointcloud(chip_smoke.scene_cloud(rng, n_points, R, t), ["x", "y", "z"], R, t, 0.0, 0.0)
    state = em.state
    for _ in range(7):
        state = core.update_time(state, cfg)
    return state


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("shape", ["small", "deployed"])
def test_march_kernel_matches_plain_version(card, shape, gated):
    """K2 against its plain version: hit counts, upper bounds and segment
    counts equal, the decrement within 2e-4 relative to max(1, |sum|)."""
    if shape == "small":
        cfg, n_rays = MapConfig(**SMALL_KW, raycast_mode="exact"), 8192
    else:
        cfg, n_rays = chip_smoke.deployed_config().replace(raycast_mode="exact"), 131072
    state = _aged_map(cfg, n_rays)
    pack, world, valid, t, gate = chip_smoke.march_inputs(
        state, cfg, n_rays, np.random.default_rng(9), gated, pose=3
    )
    before = cuda_march.KERNEL.launches
    got = cuda_march.exact_march(pack, world, valid, t, cfg, gate)
    torch.cuda.synchronize()
    assert cuda_march.KERNEL.launches == before + 1
    want = cuda_march.exact_march_reference(pack, world, valid, t, cfg, gate)
    assert float(want.hits.sum()) > 0 and bool(torch.isfinite(want.ubmin).any())
    assert torch.equal(got.hits, want.hits)
    assert torch.equal(got.ubmin, want.ubmin)
    if gated:
        assert torch.equal(got.counts, want.counts) and 0 < int(got.counts[0]) <= int(got.counts[1])
    assert float(((got.dec - want.dec).abs() / want.dec.abs().clamp(min=1.0)).max()) <= 2e-4


def test_march_kernel_empty_and_masked(card):
    """No rays: nothing launched. Every ray masked (not valid): one launch
    that writes nothing and counts no segment."""
    cfg = MapConfig(**SMALL_KW, raycast_mode="exact")
    state = _aged_map(cfg, 4096)
    pack, world, valid, t, gate = chip_smoke.march_inputs(state, cfg, 4096, np.random.default_rng(10), True, pose=3)
    before = cuda_march.KERNEL.launches
    empty = cuda_march.exact_march(pack, world[:0], valid[:0], t, cfg, gate)
    assert cuda_march.KERNEL.launches == before
    masked = cuda_march.exact_march(pack, world, torch.zeros_like(valid), t, cfg, gate)
    torch.cuda.synchronize()
    assert cuda_march.KERNEL.launches == before + 1
    for res in (empty, masked):
        assert res.counts.tolist() == [0, 0]
        assert float(res.hits.sum()) == 0 and float(res.dec.abs().sum()) == 0
        assert bool(torch.isinf(res.ubmin).all())


def test_exact_update_on_card_matches_cpu(card):
    """Three exact-march updates on the card and on the CPU: K1 twice and
    K2 once per update, and every layer within 1e-4."""
    cfg = MapConfig(**SMALL_KW, raycast_mode="exact")
    gpu, cpu = ElevationMap(cfg), ElevationMap(cfg, device="cpu")
    rng = np.random.default_rng(11)
    before = (cuda_scatter.KERNEL.launches, cuda_march.KERNEL.launches)
    for k in range(3):
        R, t, pos = chip_smoke.robot_pose(4 * k)
        pts = chip_smoke.scene_cloud(rng, 6000, R, t, r_max=2.5)
        for em in (gpu, cpu):
            em.move_to(pos, R)
            em.input_pointcloud(pts, ["x", "y", "z"], R, t, 0.0, 0.0)
            em.update_time()
    assert (cuda_scatter.KERNEL.launches, cuda_march.KERNEL.launches) == (before[0] + 6, before[1] + 3)
    names = ["elevation", "variance", "is_valid", "traversability", "upper_bound", "is_upper_bound", "normal_z"]
    got, want = gpu.get_layers(names), cpu.get_layers(names)
    for name in names:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4, err_msg=name)
