"""The PyTorch port on a CUDA card: kernels K1 and K2 and the updates through
them, the semantic fusions, the image path, post-processing (stencil
filters, plugins, polygon mask, grid-map filters), plane segmentation,
the runtime service and the DINO ViT.

Every test here needs the card and is marked ``cuda``; without one it
skips. The file imports no JAX, so it also runs where JAX is not
installed, without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from elevation_mapping_cupy_torch import MapConfig, core
from elevation_mapping_cupy_torch.mapper import ElevationMap
from elevation_mapping_cupy_torch.ops import cuda_march, cuda_scatter, raycast, scatter

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


def _scatter_case(card, rng, b, k, n, n_cells, idx, exact):
    """K1 against its plain version on (b, k, n) streams over ``idx``:
    integer streams bit for bit, value streams within 2e-4 relative to
    max(1, |sum|) (a hot cell sums tens of thousands of values)."""
    mask = torch.from_numpy(rng.random((b, n)) > 0.1).to(card)
    vals = rng.normal(0.5, 0.3, (b, k, n)).astype(np.float32)
    for s, e in enumerate(exact):
        if e:
            vals[:, s] = rng.integers(0, 3, (b, n))
    vals = torch.from_numpy(vals).to(card)
    idx = torch.from_numpy(idx.astype(np.int32)).to(card)
    before = cuda_scatter.KERNEL.launches
    got = cuda_scatter.scatter_add_streams(idx, mask, vals, n_cells)
    torch.cuda.synchronize()
    assert cuda_scatter.KERNEL.launches == before + 1
    want = cuda_scatter.scatter_add_streams_reference(idx, mask, vals, n_cells)
    assert got.shape == (b, k, n_cells)
    for s, e in enumerate(exact):
        if e:
            assert torch.equal(got[:, s], want[:, s]), f"integer stream {s}"
        else:
            rel = ((got[:, s] - want[:, s]).abs() / want[:, s].abs().clamp(min=1.0)).max()
            assert float(rel) <= 2e-4, f"value stream {s}: {float(rel)}"


@pytest.mark.parametrize("hot_cells", [1, 16])
def test_kernel_with_every_point_on_a_few_cells(card, hot_cells):
    """The most contended input: 131072 points on 1 or 16 cells of the
    deployed map (shared-memory path)."""
    rng = np.random.default_rng(1)
    n, n_cells = 131072, 202 * 202
    assert cuda_scatter.launch_plan(1, 4, n, n_cells).path == "private"
    cells = rng.choice(n_cells, hot_cells, replace=False)
    idx = cells[rng.integers(0, hot_cells, (1, n))]
    _scatter_case(card, rng, 1, 4, n, n_cells, idx, (False, False, True, True))


@pytest.mark.parametrize(
    "b, k, n_cells, path",
    [(1, 2, 58112, "private"), (1, 2, 58113, "global"), (1, 4, 400 * 400, "global"), (4, 7, 202 * 202, "private")],
)
def test_kernel_paths_by_map_size(card, b, k, n_cells, path):
    """Both paths of K1 at the sizes where the choice turns (58112 cells is
    the largest map that fits in shared memory), a 400x400 map, and B=4
    with K=7 in one launch; indices include some outside the map."""
    rng = np.random.default_rng(2)
    n = 50000
    assert cuda_scatter.launch_plan(b, k, n, n_cells).path == path
    idx = rng.integers(-3, n_cells + 3, (b, n))
    exact = tuple(s % 2 == 1 for s in range(k))
    _scatter_case(card, rng, b, k, n, n_cells, idx, exact)


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
# 82x82 cells and 141 march steps: rays long enough for several passes of 32 lanes
SYNTHETIC_KW = dict(resolution=0.05, map_length=4.0, max_ray_length=5.0, max_points=8192)


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


def _assert_march_equal(got, want, gated):
    assert torch.equal(got.hits, want.hits)
    assert torch.equal(got.ubmin, want.ubmin)
    if gated:
        assert torch.equal(got.counts, want.counts)
    assert float(((got.dec - want.dec).abs() / want.dec.abs().clamp(min=1.0)).max()) <= 2e-4


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("shape", ["small", "deployed", "default"])
def test_march_kernel_matches_plain_version(card, shape, gated):
    """K2 against its plain version: hit counts, upper bounds and segment
    counts equal, the decrement within 2e-4 relative to max(1, |sum|)."""
    if shape == "small":
        cfg, n_rays = MapConfig(**SMALL_KW, raycast_mode="exact"), 8192
    elif shape == "default":  # 2 m rays: 70 steps
        cfg, n_rays = MapConfig(raycast_mode="exact"), 32768
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
    _assert_march_equal(got, want, gated)
    if gated:
        assert 0 < int(got.counts[0]) <= int(got.counts[1])


def synthetic_march_inputs(cfg, kind: str, lanes: int, device, gated: bool):
    """K2's inputs on a made-up map where nearly every sample writes: a
    third of the cells invalid (upper-bound writes), the others eligible
    and 10 m high (every sample penetrates them) with an upper bound on
    every other row, and the far rows neither (the gate culls them).

    ``kind`` "parallel": 4096 rays along one line, so one column of cells
    takes every hit. "lengths": rays in all directions whose live-step
    counts cover 0, 1, lanes - 1, lanes, lanes + 1 and 2 * lanes + 1, where
    a ray ends in or one past a pass of its group of lanes."""
    n = cfg.cell_n
    ii, jj = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    code = torch.where((ii + jj) % 3 == 0, 1.0, 2.0)
    code = torch.where(ii >= (3 * n) // 4, 0.0, code)
    ub_thresh = torch.where((code == 1.0) | (ii % 2 == 0), math.inf, 0.1)
    ones = torch.ones(n, n)
    pack = torch.stack(
        [10.0 * ones, 0.05 * ones, ub_thresh, code, 0.1 * ones, 0.05 * ones, 0.99 * ones, 0.0 * ones], dim=-1
    ).reshape(n * n, cuda_march.PACK_WIDTH).to(torch.float32)
    t = torch.tensor([0.03, -0.02, 0.4], dtype=torch.float32)
    rng = np.random.default_rng(12)
    if kind == "parallel":
        length = rng.uniform(0.5, 0.98 * cfg.max_ray_length, 4096)
        u = np.array([0.75, 0.25, -0.6]) / np.linalg.norm([0.75, 0.25, -0.6])
        world = t.numpy() + length[:, None] * u
    else:
        m = 4096
        length = np.linspace(0.05, (2 * lanes + 4) * cfg.ray_step + 0.4, m)
        az = rng.uniform(-math.pi, math.pi, m)
        u = np.stack([np.cos(az) * 0.8, np.sin(az) * 0.8, np.full(m, -0.6)], 1)
        world = t.numpy() + length[:, None] * u
    world = torch.from_numpy(world.astype(np.float32))
    valid = torch.ones(world.shape[0], dtype=torch.bool)
    pack, world, valid, t = (x.to(device) for x in (pack, world, valid, t))
    gate = raycast.exact_gate(pack, cfg) if gated else None
    return pack, world, valid, t, gate


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("kind", ["parallel", "lengths"])
def test_march_kernel_on_synthetic_rays(card, kind, gated):
    """K2 where one column of cells takes every hit, and on rays whose
    live-step counts sit at the edges of a pass of their lanes; two runs of
    the same inputs give equal hit counts, upper bounds and segment counts."""
    cfg = MapConfig(**SYNTHETIC_KW, raycast_mode="exact")
    lanes = cuda_march.LANES_GATED if gated else cuda_march.LANES_FLAT
    pack, world, valid, t, gate = synthetic_march_inputs(cfg, kind, lanes, card, gated)
    if kind == "lengths":
        k = cuda_march.ray_table(world, valid, t, cfg)[1]
        for want_k in (0, 1, lanes - 1, lanes, lanes + 1, 2 * lanes + 1):
            assert bool((k == want_k).any()), f"no ray with {want_k} live steps"
    got = cuda_march.exact_march(pack, world, valid, t, cfg, gate)
    again = cuda_march.exact_march(pack, world, valid, t, cfg, gate)
    torch.cuda.synchronize()
    want = cuda_march.exact_march_reference(pack, world, valid, t, cfg, gate)
    assert float(want.hits.sum()) > 0 and bool(torch.isfinite(want.ubmin).any())
    _assert_march_equal(got, want, gated)
    assert torch.equal(got.hits, again.hits) and torch.equal(got.ubmin, again.ubmin)
    if gated:
        assert torch.equal(got.counts, again.counts)
        assert 0 < int(got.counts[0]) <= int(got.counts[1])
        if kind == "parallel":  # the long rays reach the rows the gate culls
            assert int(got.counts[0]) < int(got.counts[1])


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


# ---------------------------------------------------------------------------
# semantic layers and the image path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "label, k, pairs, n_cells, integers",
    [
        ("features K=3", 3, 1, 202 * 202, False),
        ("features K=8", 8, 1, 202 * 202, False),
        ("colour count+rgb K=4", 4, 1, 202 * 202, True),
        ("colour rgb K=3", 3, 1, 202 * 202, True),
        ("colour count K=1", 1, 1, 202 * 202, True),
        ("class_max K=1 over 32 n^2 bins", 1, 2, 32 * 202 * 202, False),
    ],
)
def test_kernel_at_the_semantic_shapes(card, label, k, pairs, n_cells, integers):
    """K1 against its plain version at the shapes the semantic fusions give
    it at the deployed map and 131072 points: integer streams (0-255) bit
    for bit, value streams within 2e-4 relative to max(1, |sum|)."""
    rng = np.random.default_rng(20)
    n = 131072 * pairs
    want_path = "global" if n_cells > 58112 else "private"
    assert cuda_scatter.launch_plan(1, k, n, n_cells).path == want_path
    idx = torch.from_numpy(chip_smoke._cell_indices(rng, 1, n, 202 * 202)).to(card)
    if pairs > 1:
        idx = idx + 202 * 202 * torch.from_numpy(rng.integers(0, 9, (1, n)).astype(np.int32)).to(card)
    mask = torch.from_numpy(rng.random((1, n)) > 0.15).to(card)
    vals = rng.integers(0, 256, (1, k, n)) if integers else rng.normal(0.5, 0.3, (1, k, n))
    vals = torch.from_numpy(vals.astype(np.float32)).to(card)
    before = cuda_scatter.KERNEL.launches
    got = cuda_scatter.scatter_add_streams(idx, mask, vals, n_cells)
    torch.cuda.synchronize()
    assert cuda_scatter.KERNEL.launches == before + 1
    want = cuda_scatter.scatter_add_streams_reference(idx, mask, vals, n_cells)
    if integers:
        assert float(want.max()) < 2**24 and torch.equal(got, want), label
    else:
        assert float(((got - want).abs() / want.abs().clamp(min=1.0)).max()) <= 2e-4, label


def _bits(x: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(x.detach().cpu().numpy()).view(np.uint32)


def test_packing_helpers_on_card_equal_cpu(card):
    """decode_max / encode_max / the rgb helpers give the same bits on the
    card as on the CPU, for every float16 pattern and ids up to 0xFFFF."""
    from elevation_mapping_cupy_torch.semantic import fusions as F

    rng = np.random.default_rng(21)
    half = np.arange(1 << 16, dtype=np.uint32)
    mer = torch.from_numpy(((rng.integers(0, 1 << 16, 1 << 16).astype(np.uint32) << 16) | half).view(np.float32))
    p_cpu, c_cpu = F.decode_max(mer)
    p_gpu, c_gpu = F.decode_max(mer.to(card))
    # a NaN half decodes to a NaN on both; the card's conversion does not keep its payload
    nan = torch.isnan(p_cpu).numpy()
    assert np.array_equal(nan, torch.isnan(p_gpu).cpu().numpy()) and nan.sum() == 2046
    assert np.array_equal(_bits(p_cpu)[~nan], _bits(p_gpu)[~nan]) and torch.equal(c_cpu, c_gpu.cpu())
    prob = torch.from_numpy(np.concatenate([rng.uniform(-70000, 70000, 20000), 10.0 ** rng.uniform(-9, 5, 20000)]).astype(np.float32))
    cls = torch.from_numpy(rng.integers(0, 1 << 16, prob.shape[0]))
    assert np.array_equal(_bits(F.encode_max(prob, cls)), _bits(F.encode_max(prob.to(card), cls.to(card))))
    colour = torch.from_numpy(chip_smoke.pack_rgb(rng.integers(0, 256, (50000, 3))))
    rgb = F.rgb_float_to_uint(colour.to(card))
    assert all(torch.equal(a, b.cpu()) for a, b in zip(F.rgb_float_to_uint(colour), rgb))
    assert np.array_equal(_bits(F.uint_to_rgb_float(*rgb)), _bits(colour))
    # the 32 smallest distinct ids in unsigned order
    cand = torch.from_numpy(rng.choice(np.array([0, 7, 9, 0x80000001, 0xFFFFFFFE, 70000]), 5000))
    assert scatter.smallest_unique(cand.to(card), 4, F.UNIQUE_FILL).tolist() == [0, 7, 9, 70000]
    assert scatter.smallest_unique(cand.to(card), 8, F.UNIQUE_FILL).tolist() == [0, 7, 9, 70000, 0x80000001, 0xFFFFFFFE] + [0xFFFFFFFF] * 2


SEMANTIC_TABLE = (
    ("rgb", "color"), ("f_avg", "average"), ("f_bayes", "bayesian_inference"), ("f_dir", "class_bayesian"),
    ("max_.*", "class_max"), ("default", "class_average"),
)
SEMANTIC_CHANNELS = ["rgb", "grass", "f_avg", "f_bayes", "f_dir", "max_a", "max_b"]


def test_semantic_update_on_card_matches_cpu(card):
    """Two updates with all six fusions on the card and on the CPU from the
    same clouds: 3 + 6 K1 launches an update (one per fusion: class_max's
    two layers share one), float layers within 1e-4, the packed colour layer
    and the class ids bit for bit."""
    cfg = MapConfig(**SMALL_KW, raycast_mode="polar", pointcloud_channel_fusions=SEMANTIC_TABLE)
    gpu, cpu = ElevationMap(cfg), ElevationMap(cfg, device="cpu")
    rng = np.random.default_rng(22)
    before = cuda_scatter.KERNEL.launches
    for k in range(2):
        R, t, pos = chip_smoke.robot_pose(4 * k)
        n = 6000
        cloud = np.concatenate([
            chip_smoke.scene_cloud(rng, n, R, t, r_max=2.5),
            chip_smoke.pack_rgb(rng.integers(0, 256, (n, 3)))[:, None],
            rng.uniform(-1, 1, (n, 4)).astype(np.float32),
            chip_smoke.pack_class(rng.uniform(0.2, 1, (n, 2)).astype(np.float32), rng.integers(1, 41, (n, 2))),
        ], axis=1)
        for em in (gpu, cpu):
            em.move_to(pos, R)
            em.input_pointcloud(cloud, ["x", "y", "z"] + SEMANTIC_CHANNELS, R, t, 0.0, 0.0)
    assert cuda_scatter.KERNEL.launches == before + 2 * 9
    assert gpu.cfg.semantic_layers == cpu.cfg.semantic_layers == tuple(SEMANTIC_CHANNELS)
    got, want = gpu.get_layers(SEMANTIC_CHANNELS + ["elevation"]), cpu.get_layers(SEMANTIC_CHANNELS + ["elevation"])
    assert np.array_equal(got["rgb"].view(np.uint32), want["rgb"].view(np.uint32))
    assert np.count_nonzero(want["rgb"]) > 300
    for name in SEMANTIC_CHANNELS[1:] + ["elevation"]:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4, err_msg=name)
    ids_gpu, ids_cpu = gpu.state.id_max.cpu(), cpu.state.id_max
    assert float((ids_gpu == ids_cpu).float().mean()) >= 0.999  # a tie between two classes' sums may fall either way
    assert int(ids_cpu.max()) >= 30  # 40 ids in the clouds: the 32 smallest were kept
    torch.testing.assert_close(gpu.state.sem_new.cpu(), cpu.state.sem_new, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mode", ["shadow", "bresenham"])
def test_input_image_on_card_matches_cpu(card, mode):
    """One image onto a mapped state, on the card and on the CPU: neither
    kernel is launched; valid agrees on 99.5 % of cells and the fused
    layers on the cells valid in both."""
    cfg = MapConfig(**SMALL_KW, raycast_mode="polar", image_occlusion_mode=mode)
    gpu, cpu = ElevationMap(cfg), ElevationMap(cfg, device="cpu")
    rng = np.random.default_rng(23)
    R, t, pos = chip_smoke.robot_pose(0)
    cloud = chip_smoke.scene_cloud(rng, 8000, R, t, r_max=2.5)
    img = np.concatenate([rng.integers(0, 256, (3, 48, 64)), rng.random((1, 48, 64))]).astype(np.float32)
    K = np.array([[20, 0, 32], [0, 20, 24], [0, 0, 1]], np.float32)
    Rc = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    tc = np.array([0.1, 0.05, 1.3], np.float32)
    D = np.array([0.01, -0.005, 0.001, 0.0005, 0.0], np.float32)
    before = (cuda_scatter.KERNEL.launches, cuda_march.KERNEL.launches)
    valid = {}
    for em in (gpu, cpu):
        em.input_pointcloud(cloud, ["x", "y", "z"], R, t, 0.0, 0.0)
        args = [torch.as_tensor(a, device=em.device) for a in (Rc, tc, K, D)]
        valid[em.device.type] = core.image_correspondence(em.state, 48, 64, *args, cfg)[1].cpu().numpy()
        em.input_image(img, ["rgb", "mask"], Rc, tc, K, D)
    assert (cuda_scatter.KERNEL.launches, cuda_march.KERNEL.launches) == (before[0] + 3, before[1])
    assert (valid["cuda"] == valid["cpu"]).mean() >= 0.995 and valid["cpu"].sum() > 300
    both = (valid["cuda"] & valid["cpu"])[1:-1, 1:-1][::-1, ::-1]
    got, want = gpu.get_layers(["rgb", "mask"]), cpu.get_layers(["rgb", "mask"])
    assert (got["rgb"].view(np.uint32) == want["rgb"].view(np.uint32))[both].mean() >= 0.995
    assert (np.abs(got["mask"] - want["mask"]) <= 1e-4)[both].mean() >= 0.995


# ---------------------------------------------------------------------------
# post-processing
# ---------------------------------------------------------------------------

def _semantic_map_pair(card, frames=2):
    """A small semantic map (semantic_mem.yaml's layers) on the card and the
    same state on the CPU."""
    from elevation_mapping_cupy_torch.state import state_from_numpy, state_to_numpy

    cfg = chip_smoke.semantic_config().replace(resolution=0.1, map_length=6.0, max_ray_length=2.0, max_points=8192)
    gpu = ElevationMap(cfg)
    rng = np.random.default_rng(30)
    names = ["x", "y", "z"] + list(chip_smoke.MEM_CHANNELS)
    for k in range(frames):
        R, t, pos = chip_smoke.robot_pose(3 * k)
        gpu.move_to(pos, R)
        gpu.input_pointcloud(chip_smoke.mem_cloud(rng, 6000, R, t), names, R, t, 0.0, 0.0)
    cpu = ElevationMap(gpu.cfg, device="cpu")
    cpu.state = state_from_numpy(state_to_numpy(gpu.state), "cpu")
    return gpu, cpu


@pytest.mark.parametrize("size, iterations", [(1, 2), (2, 3), (5, 5)])
def test_stencil_filters_on_card_match_cpu(card, size, iterations):
    """min_filter / max_filter bit for bit, uniform_smooth within 1e-6, on a
    mapped state."""
    from elevation_mapping_cupy_torch.ops import stencil

    gpu, _ = _semantic_map_pair(card)
    h, m = gpu.state.layers[0], gpu.state.layers[2]
    for fn in (stencil.min_filter, stencil.max_filter):
        got, want = fn(h, m, size, iterations), fn(h.cpu(), m.cpu(), size, iterations)
        assert got.device.type == "cuda"
        assert np.array_equal(_bits(got), _bits(want))
    got, want = stencil.uniform_smooth(h, 2, 2 * size + 1), stencil.uniform_smooth(h.cpu(), 2, 2 * size + 1)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)


def test_plugins_on_card_match_cpu(card):
    """The ten plugins (plugin_config.yaml's eight, semantic_filter and
    features_pca) exported on the card and on the CPU from the same state:
    chip_smoke's comparison, and no kernel launched."""
    gpu, cpu = _semantic_map_pair(card)
    settings = chip_smoke.PLUGIN_SETTINGS + chip_smoke.SEMANTIC_PLUGIN_SETTINGS
    for em in (gpu, cpu):
        em.plugin_manager.init(*chip_smoke.plugin_settings(settings))
    names = gpu.plugin_manager.layer_names
    assert len(names) == 10 and gpu.plugin_manager.layers.device.type == "cuda"
    before = (cuda_scatter.KERNEL.launches, cuda_march.KERNEL.launches)
    got, want = gpu.get_layers(names), cpu.get_layers(names)
    torch.cuda.synchronize()
    assert (cuda_scatter.KERNEL.launches, cuda_march.KERNEL.launches) == before
    stats = chip_smoke._compare_plugin_layers("plugins", got, want)
    assert stats["features_pca"]["channels"]


def test_polygon_query_and_mask_on_card_match_cpu(card):
    """polygon_mask on the card equals the CPU's for polygons of 3 to 9
    vertices, some past the map's edge; the mapper's query gives the same
    result, count and hull."""
    from elevation_mapping_cupy_torch.ops import polygon

    gpu, cpu = _semantic_map_pair(card)
    rng = np.random.default_rng(31)
    centre = gpu.state.center[:2]
    for v in (3, 5, 9):
        ang = np.sort(rng.uniform(0, 2 * np.pi, v))
        poly = np.stack([np.cos(ang), np.sin(ang)], 1) * rng.uniform(0.5, 4.0, (v, 1))
        padded = np.zeros((max(8, 1 << int(np.ceil(np.log2(v)))), 2), np.float32)
        padded[:v] = poly + centre.cpu().numpy()
        got = polygon.polygon_mask(torch.from_numpy(padded).to(card), v, centre, gpu.cfg)
        want = polygon.polygon_mask(torch.from_numpy(padded), v, centre.cpu(), gpu.cfg)
        assert torch.equal(got.cpu(), want) and float(want.sum()) > 0
        res_g, res_c = np.zeros(3), np.zeros(3)
        n_g = gpu.get_polygon_traversability(padded[:v], res_g)
        n_c = cpu.get_polygon_traversability(padded[:v], res_c)
        assert n_g == n_c and res_g[0] == res_c[0] and res_g[2] == res_c[2]
        assert abs(res_g[1] - res_c[1]) <= 1e-6 * max(1.0, abs(res_c[1]))
        assert np.array_equal(gpu.untraversable_polygon, cpu.untraversable_polygon)


def test_initialize_map_on_card_matches_cpu(card):
    gpu, cpu = _semantic_map_pair(card, frames=1)
    pts = chip_smoke.INIT_POINTS * 0.6 + gpu.center
    for em in (gpu, cpu):
        em.initialize_map(pts, "linear")
    names = ["elevation", "variance", "is_valid", "upper_bound"]
    got, want = gpu.get_layers(names), cpu.get_layers(names)
    for name in names:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5, err_msg=name)


def test_gridmap_filters_on_card_match_cpu(card):
    """The grid-map filter library on the card against the CPU, on a height
    map with NaN holes: within 1e-5, NaN where the CPU has NaN."""
    from elevation_mapping_cupy_torch.ops import gridmap_filters as gf

    rng = np.random.default_rng(32)
    h = rng.normal(0, 0.2, (90, 110)).astype(np.float32)
    h[20:40, 30:60] = np.nan
    h[rng.integers(0, 90, 50), rng.integers(0, 110, 50)] = np.nan
    hg, hc = torch.from_numpy(h).to(card), torch.from_numpy(h)
    cases = {
        "inpaint_min_values": lambda x: gf.inpaint_min_values(x),
        "inpaint_bilinear": lambda x: gf.inpaint_bilinear(x, 16),
        "resample_up": lambda x: gf.resample(torch.nan_to_num(x), (180, 220)),
        "resample_down": lambda x: gf.resample(torch.nan_to_num(x), (45, 37)),
        "median": lambda x: gf.median_filter(x, 5),
        "box_blur": lambda x: gf.box_blur(x, 3, 2),
        "gaussian_blur": lambda x: gf.gaussian_blur(x, 5, 1.0),
        "dilate": lambda x: gf.dilate(x, 3, True),
        "erode": lambda x: gf.erode(x, 5, False),
        "curvature": lambda x: torch.stack(gf.estimate_gradient_and_curvature(x, 0.04)),
    }
    for name, fn in cases.items():
        got, want = fn(hg).cpu().numpy(), fn(hc).numpy()
        assert np.array_equal(np.isnan(got), np.isnan(want)), name
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# plane segmentation
# ---------------------------------------------------------------------------

def _planeseg_scene():
    return chip_smoke.planeseg_scene(np.random.default_rng(0))


@pytest.mark.parametrize("b, k", [(1, 10), (1, 1), (16, 10)])
def test_kernel_at_the_planeseg_shapes(card, b, k):
    """K1 at extract_planes' shapes (10 moment streams or the bad-cell
    count over 65 bins, ~70 % of the cells on one bin) against its plain
    version: counts bit for bit, values within 2e-4 relative."""
    labels = torch.from_numpy(chip_smoke.planeseg_labels(_planeseg_scene())).reshape(1, -1).to(torch.int32)
    rng = np.random.default_rng(40 + b + k)
    n = labels.shape[1]
    idx = labels.expand(b, n).contiguous().to(card)
    mask = torch.from_numpy(rng.random((b, n)) > 0.02).to(card)
    vals = rng.normal(-2.0, 1.0, (b, k, n)).astype(np.float32)
    if k == 1:
        vals = (rng.random((b, 1, n)) < 0.1).astype(np.float32)
    vals = torch.from_numpy(vals).to(card)
    assert cuda_scatter.launch_plan(b, k, n, 65).path == "private"
    got = cuda_scatter.scatter_add_streams(idx, mask, vals, 65)
    want = cuda_scatter.scatter_add_streams_reference(idx, mask, vals, 65)
    torch.cuda.synchronize()
    if k == 1:
        assert torch.equal(got, want)
    else:
        rel = ((got - want).abs() / want.abs().clamp(min=1.0)).max()
        assert float(rel) <= 2e-4


@pytest.mark.parametrize("connectivity", [4, 8])
def test_connected_components_on_card_matches_cpu(card, connectivity):
    """Labels bit for bit, a batch of masks and the round cap included."""
    from elevation_mapping_cupy_torch.planeseg import extract as E

    rng = np.random.default_rng(41)
    masks = torch.from_numpy(rng.random((3, 90, 70)) < 0.6)
    for max_iters in (0, 2):
        got = E.connected_components(masks.to(card), connectivity, max_iters)
        want = E.connected_components(masks, connectivity, max_iters)
        assert torch.equal(got.cpu(), want)


def test_extract_planes_on_card_matches_cpu(card):
    """bench_planeseg's scene: labels, plane_valid and needs_refine equal,
    plane normals and supports within 1e-5, two K1 launches."""
    from elevation_mapping_cupy_torch.planeseg import extract as E

    h = E.preprocess(torch.from_numpy(_planeseg_scene()))
    params = E.PlaneSegParams()
    before = cuda_scatter.KERNEL.launches
    got = E.extract_planes(h.to(card), 0.04, params)
    torch.cuda.synchronize()
    assert cuda_scatter.KERNEL.launches == before + 2
    want = E.extract_planes(h, 0.04, params)
    for name in ("labels", "plane_valid", "needs_refine"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    used = want.plane_valid | want.needs_refine
    assert int(used.sum()) >= 3
    torch.testing.assert_close(got.plane_normals.cpu()[used], want.plane_normals[used], rtol=0, atol=1e-5)
    torch.testing.assert_close(got.plane_support.cpu()[used], want.plane_support[used], rtol=0, atol=1e-5)


def test_planeseg_pipeline_on_card_matches_cpu(card):
    """update on the card against the CPU port (labels equal, layers within
    1e-5), and update_batch against update on the card."""
    from elevation_mapping_cupy_torch.planeseg import PlaneDecompositionPipeline

    h = _planeseg_scene()
    got = PlaneDecompositionPipeline(0.04, device="cuda").update(h)
    want = PlaneDecompositionPipeline(0.04, device="cpu").update(h)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert len(got.regions) == len(want.regions) >= 3
    for name in ("filtered_map", "elevation", "smooth_planar"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0, atol=1e-5, err_msg=name)
    maps = np.stack([h, h[::-1].copy()])
    pipe = PlaneDecompositionPipeline(0.04, device="cuda")
    for b, t in enumerate(pipe.update_batch(maps)):
        np.testing.assert_array_equal(t.labels, pipe.update(maps[b]).labels)


# ---------------------------------------------------------------------------
# batched multi-map updates (parallel/, runtime/datagen.py)
# ---------------------------------------------------------------------------

def test_batched_step_on_card_matches_per_map(card):
    """A batched step of 4 maps at the default MapConfig (clouds from
    make_batch_clouds on the card) launches K1 three times and equals each
    map's own update on the card within 1e-5 on 99.9 % of cells."""
    from elevation_mapping_cupy_torch.nn.traversability import DEFAULT_WEIGHT_FILE, load_weights_npz
    from elevation_mapping_cupy_torch.parallel import batched_update, init_batch
    from elevation_mapping_cupy_torch.runtime import datagen
    from elevation_mapping_cupy_torch.state import take_map

    B, n = 4, 20000
    cfg = MapConfig(max_points=n)
    w = load_weights_npz(DEFAULT_WEIGHT_FILE).to(card)
    pts, t, _ = datagen.make_batch_clouds(datagen.make_generator(0, card), B, cfg.cell_n, cfg.resolution, n)
    assert pts.device.type == "cuda" and pts.shape == (B, n, 3)
    mask = torch.ones((B, n), dtype=torch.bool, device=card)
    R = torch.eye(3, device=card).expand(B, 3, 3).contiguous()
    z = torch.zeros(B, device=card)
    states = init_batch(cfg, B, card)
    states = batched_update(states, pts, mask, R, t, z, z, w, cfg)
    before = cuda_scatter.KERNEL.launches
    out = batched_update(states, pts, mask, R, t, z, z, w, cfg)
    torch.cuda.synchronize()
    assert cuda_scatter.KERNEL.launches == before + 3
    assert float((out.layers[:, 2] > 0.5).float().mean()) > 0.02
    for b in range(B):
        one = core.update_pointcloud(take_map(states, b), pts[b], mask[b], R[b], t[b], 0.0, 0.0, w, cfg)
        for name, x, y in zip(out._fields, take_map(out, b), one):
            close = ((x.double() - y.double()).abs() <= 1e-5).float().mean() if x.numel() else 1.0
            assert float(close) >= 0.999, f"map {b} {name}: {float(close)}"


def test_batched_move_to_on_card_is_bitwise(card):
    from elevation_mapping_cupy_torch.parallel import batched_move_to, init_batch
    from elevation_mapping_cupy_torch.state import take_map

    B = 3
    cfg = MapConfig(resolution=0.1, map_length=4.0, semantic_layers=("rgb",))
    states = init_batch(cfg, B, card)
    g = torch.Generator(device=card).manual_seed(0)
    states = states._replace(layers=torch.rand(states.layers.shape, generator=g, device=card),
                             semantic=torch.rand(states.semantic.shape, generator=g, device=card))
    pos = (torch.rand((B, 3), generator=g, device=card) - 0.5) * 2.0
    Rs = torch.eye(3, device=card).expand(B, 3, 3).contiguous()
    moved = batched_move_to(states, pos, Rs, cfg)
    for b in range(B):
        one = core.move_to(take_map(states, b), pos[b], Rs[b], cfg)
        for name, x, y in zip(moved._fields, take_map(moved, b), one):
            assert torch.equal(x, y), f"map {b} {name}"


def test_service_raw_ingest_on_card_matches_cpu(card):
    """MappingService on the card: raw PointCloud2-style frames through the
    native ring, 3 K1 launches per frame, the final map equal to the CPU
    service's within 1e-4 on 99.9 % of cells."""
    from elevation_mapping_cupy_torch.runtime.service import MappingService

    cfg = MapConfig(resolution=0.1, map_length=4.0, max_ray_length=2.0, max_points=8192)
    rng = np.random.default_rng(3)
    frames = []
    for k in range(3):
        R, t, pos = chip_smoke.robot_pose(k)
        frames.append((R, t, pos, chip_smoke.raw_records(chip_smoke.scene_cloud(rng, 8192, R, t, r_max=1.8), rng)))
    maps = []
    for dev in ("cuda", "cpu"):
        svc = MappingService(cfg, device=dev)
        svc.enable_raw_ingest()
        before = cuda_scatter.KERNEL.launches
        for k, (R, t, pos, raw) in enumerate(frames):
            svc.update_pose(pos, R)
            assert svc.enqueue_raw_pointcloud(raw, 8192, chip_smoke.POINT_STEP, [0, 4, 8], ["x", "y", "z"], R, t)
            assert svc.spin_once(now=0.1 * (k + 1)) == 1
        if dev == "cuda":
            torch.cuda.synchronize()
            assert cuda_scatter.KERNEL.launches == before + 9
            assert svc.mapper.state.layers.device.type == "cuda"
        maps.append(svc.mapper.get_layers(chip_smoke.LAYERS))
    for name in chip_smoke.LAYERS:
        a, b = maps[0][name], maps[1][name]
        close = (np.isnan(a) & np.isnan(b)) | (np.abs(np.nan_to_num(a, nan=1e9) - np.nan_to_num(b, nan=1e9)) <= 1e-4)
        assert close.mean() >= 0.999, name


@pytest.mark.parametrize("dtype,tok_tol,code_tol", [("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 5e-3)])
def test_dino_on_card_matches_cpu(card, dtype, tok_tol, code_tol):
    """The ViT on the card against the CPU port with the same seeded weights
    (vit_tiny/8, 64x48): float32 within 1e-4, bf16 tokens within 2e-2 and
    code within 5e-3."""
    from elevation_mapping_cupy_torch.sensor import dino as D

    cfg = D.ViTConfig(variant="vit_tiny", patch_size=8, dim=12, compute_dtype=getattr(torch, dtype))
    model = D.init_vit_params(torch.Generator().manual_seed(7), cfg)
    img = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 64, 48)).astype(np.float32))
    want = D.vit_features(model, img, cfg)[0], D.dino_featurize(model, img, cfg)[1]
    model = model.to(card)
    got = D.vit_features(model, img.to(card), cfg)[0], D.dino_featurize(model, img.to(card), cfg)[1]
    for g, w, tol in zip(got, want, (tok_tol, code_tol)):
        assert g.device.type == "cuda" and g.dtype == torch.float32
        assert float((g.cpu() - w).abs().max()) <= tol


def test_sensor_node_on_card(card):
    """PointcloudSensorNode with a DINO model on the card: the same cloud as
    the CPU node's (seed 0 weights), DINO channels within 5e-3 at bf16."""
    from elevation_mapping_cupy_torch.sensor.pointcloud import PointcloudParameter, PointcloudSensorNode

    depth, rgb, K, _, _ = chip_smoke.sensor_frame(0)
    depth, rgb = depth[:96, :128], rgb[:, :96, :128]
    param = PointcloudParameter(channels=("a", "b"))
    clouds = [PointcloudSensorNode(param, semantic_model="dino_vits16", device=dev)(depth, K, rgb=rgb)
              for dev in ("cuda", "cpu")]
    (c_gpu, names), (c_cpu, names_cpu) = clouds
    assert names == names_cpu == ["x", "y", "z", "rgb", "a", "b"]
    np.testing.assert_array_equal(c_gpu[:, :4].view(np.uint32), c_cpu[:, :4].view(np.uint32))
    assert np.abs(c_gpu[:, 4:] - c_cpu[:, 4:]).max() <= 5e-3


def test_resolve_model_propagates_card_errors(card):
    """An out-of-memory error on the card is a RuntimeError: resolve_model
    lets it through instead of answering with random features."""
    from elevation_mapping_cupy_torch.sensor import networks

    def huge(**kw):
        return torch.empty(1 << 46, device=card)

    networks.MODELS["huge_for_test"] = huge
    try:
        with pytest.raises(torch.OutOfMemoryError):
            networks.resolve_model("huge_for_test", channels=["a"], device=card)
    finally:
        del networks.MODELS["huge_for_test"]
