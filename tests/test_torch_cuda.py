"""The PyTorch port on a CUDA card against its plain PyTorch versions and the
CPU: the kernels K1, K2 and D1 to D5 and every path through them (updates,
the exact march and replay, the semantic fusions, the image path,
post-processing, plane segmentation, batches of maps, sharded worlds, the
runtime service, the sensor sidecar and the DINO ViT, the profile entry
point and the shipped examples), with each path's launches of each kernel.

Every test here needs the card and is marked ``cuda``; without one it
skips. The file imports no JAX, so it also runs where JAX is not
installed, without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from elevation_mapping_cupy_torch import MapConfig, core, kernels
from elevation_mapping_cupy_torch.mapper import ElevationMap
from elevation_mapping_cupy_torch.ops import cuda_march, cuda_scatter, raycast, scatter, stencil
from elevation_mapping_cupy_torch.ops.geometry import Block
from tests import torch_scenes

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _counts() -> dict:
    return {name: k.launches for name, k in kernels.registered_kernels().items()}


def _launched(before: dict, k1: int, k2: int, d1: int, d2: int, d45: int, times: int = 1) -> None:
    """Each kernel's launches since ``before``: K1, K2, D1, D2 and D4 per
    call, over ``times`` calls. D3 (the polar cube's scans) runs wherever D2
    does, once per polar cleanup, so it takes D2's count; D5 (the fusion's
    proposals) wherever D4 (the association) does, once per update or
    batched step of whole maps, so it takes D4's."""
    torch.cuda.synchronize()
    now = _counts()
    got = {name: now[name] - before[name] for name in now}
    want = {"scatter_add_streams": k1, "exact_march": k2, "dilation_fill": d1, "polar_evaluate": d2,
            "polar_scan": d2, "points_associate": d45, "points_fuse": d45}
    assert got == {name: n * times for name, n in want.items()}, got


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


def _dilation_inputs(card, rng, b, h, w, masks):
    """(heights, mask) as the update hands them to the dilation: channel 5
    of a (b, 7, h, w) stack and the sum of channels 2 and 6 (0, 1 or 2).
    ``masks``: every cell valid, none, or a random share with NaN heights."""
    layers = rng.normal(0.0, 1.0, (b, 7, h, w)).astype(np.float32)
    layers[:, 2] = {"valid": 1.0, "invalid": 0.0}.get(masks, rng.random((b, h, w)) < 0.3)
    layers[:, 6] = 0.0 if masks != "random" else rng.random((b, h, w)) < 0.1
    if masks == "random":
        layers[:, 5][rng.random((b, h, w)) < 0.1] = np.nan
    x = torch.from_numpy(layers).to(card)
    return x[:, 5], x[:, 2] + x[:, 6]


def _assert_dilation_equal(height, mask, size, block=None, edges=None):
    """The kernel against its plain version on the same card tensors: one
    launch, both outputs equal in bits (NaN heights included)."""
    before = stencil.KERNEL.launches
    got = stencil.dilation_fill(height, mask, size, block, edges)
    torch.cuda.synchronize()
    assert stencil.KERNEL.launches == before + 1
    want = stencil.dilation_fill_reference(height, mask, size, block, edges)
    for g, w in zip(got, want):
        assert g.shape == w.shape == height.shape
        np.testing.assert_array_equal(g.cpu().numpy().view(np.uint32), w.cpu().numpy().view(np.uint32))
    return got


@pytest.mark.parametrize("masks", ["valid", "invalid", "random"])
@pytest.mark.parametrize("hw", [(202, 202), (150, 230)])
@pytest.mark.parametrize("b", [1, 8, 64])
@pytest.mark.parametrize("size", [1, 2, 3, 10])
def test_dilation_kernel_matches_plain_version(card, size, b, hw, masks):
    """The dilation kernel bit for bit against its plain version: the
    deployed (3), datagen (2) and initialize_map (10) sizes and 1, at B = 1,
    8 and 64, on the deployed map and a non-square one."""
    rng = np.random.default_rng(size * 1000 + b)
    height, mask = _dilation_inputs(card, rng, b, *hw, masks)
    _, out_mask = _assert_dilation_equal(height, mask, size)
    if masks == "invalid":
        assert not bool((out_mask > 0.5).any())


@pytest.mark.parametrize("size", [15, 16])
def test_dilation_kernel_on_both_sides_of_the_tiled_sizes(card, size):
    """Up to size 15 the kernel scans a shared-memory halo, above it each
    cell tests its own neighbours: the largest tiled size and the first
    direct one."""
    rng = np.random.default_rng(size)
    height, mask = _dilation_inputs(card, rng, 2, 150, 230, "random")
    sparse = torch.from_numpy(rng.random(mask.shape) < 0.1).to(card)
    mask = torch.where(sparse, mask, 0.0)  # usable neighbours far apart: long scans
    _assert_dilation_equal(height, mask, size)


def _block_case(card, rng, kind, size, b=2):
    """A block of a 40 x 37 map and what a process holding it passes the
    dilation: whole rows (their wrapped neighbours found in the block, or
    given as ``row_wrap``'s edges), a block at the left or the right
    border with its edges, and one between them."""
    gh, gw, r0, h = 40, 37, 10, 12
    c0, w = {"rows": (0, gw), "rows_edges": (0, gw), "left": (0, 15), "right": (22, 15), "inner": (8, 15)}[kind]
    height, mask = _dilation_inputs(card, rng, b, h, w, "random")
    edges = None
    if kind == "rows_edges":
        edges = stencil.row_wrap(torch.stack([height, mask], dim=-3), size)
    elif kind in ("left", "right"):
        edges = tuple(
            torch.from_numpy(np.stack([rng.normal(0.0, 1.0, (b, h, size)), rng.random((b, h, size)) < 0.3], 1)
                             .astype(np.float32)).to(card)
            for _ in range(2)
        )
    return height, mask, Block(r0, c0, h, w, gh, gw), edges


@pytest.mark.parametrize("kind", ["rows", "rows_edges", "left", "right", "inner"])
@pytest.mark.parametrize("size", [1, 3])
def test_dilation_kernel_on_blocks_matches_plain_version(card, size, kind):
    height, mask, block, edges = _block_case(card, np.random.default_rng(size), kind, size)
    got = _assert_dilation_equal(height, mask, size, block, edges)
    if kind == "rows_edges":  # the edges a block of whole rows would find itself
        for g, w in zip(got, stencil.dilation_fill(height, mask, size, block)):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_dilation_kernel_takes_any_leading_axes(card):
    """One (H, W) map, as initialize_map passes it, and (2, 3, H, W)."""
    rng = np.random.default_rng(4)
    height, mask = _dilation_inputs(card, rng, 6, 33, 41, "random")
    _assert_dilation_equal(height[0], mask[0], 2)
    _assert_dilation_equal(height.reshape(2, 3, 33, 41), mask.reshape(2, 3, 33, 41), 2)


def test_dilation_kernel_launches_once_per_call_and_per_update(card):
    """KERNEL.launches rises by one per call, and by one per core.dilation
    span of an update on the card."""
    import time

    from elevation_mapping_cupy_torch import tracing

    height, mask = _dilation_inputs(card, np.random.default_rng(5), 1, 202, 202, "random")
    before = stencil.KERNEL.launches
    for _ in range(3):
        stencil.dilation_fill(height, mask, 3)
    assert stencil.KERNEL.launches == before + 3
    cfg = MapConfig(resolution=0.1, map_length=4.0, max_ray_length=1.5, max_points=8192, raycast_mode="polar")
    em = ElevationMap(cfg)
    rng = np.random.default_rng(6)
    t0 = time.perf_counter_ns()
    before = stencil.KERNEL.launches
    for k in range(2):
        R, t, pos = torch_scenes.robot_pose(4 * k)
        em.move_to(pos, R)
        em.input_pointcloud(torch_scenes.scene_cloud(rng, 6000, R, t, r_max=2.5), ["x", "y", "z"], R, t, 0.0, 0.0)
    torch.cuda.synchronize()
    spans = [s for s in tracing.spans(t0) if s.name == "core.dilation"]
    assert stencil.KERNEL.launches - before == len(spans) == 2


# ---------------------------------------------------------------------------
# the polar evaluation kernel (csrc/polar_evaluate.cu)
# ---------------------------------------------------------------------------

_POLAR_EVALUATE = raycast.polar_evaluate


def _capture_polar(monkeypatch) -> list:
    """Records the arguments of every ``raycast.polar_evaluate`` call; each
    call goes on to the kernel."""
    calls = []

    def spy(*args):
        calls.append(args)
        return _POLAR_EVALUATE(*args)

    monkeypatch.setattr(raycast, "polar_evaluate", spy)
    return calls


def _robot_evaluation(monkeypatch, cfg, n_points=131072):
    """The evaluation's arguments in one robot update on the card: a map
    of a few updates of the smoke scene, aged past the recency gate, so that
    cells can be hit, lose validity and take upper bounds."""
    em = ElevationMap(cfg.replace(raycast_mode="polar"))
    em.state = _aged_map(cfg, n_points)
    calls = _capture_polar(monkeypatch)
    R, t, pos = torch_scenes.robot_pose(3)
    em.move_to(pos, R)
    em.input_pointcloud(torch_scenes.scene_cloud(np.random.default_rng(9), n_points, R, t), ["x", "y", "z"], R, t,
                        0.0, 0.0)
    assert len(calls) == 1
    return calls[0]


def _batch_evaluation(monkeypatch, cfg, b, card, n_points=100_000):
    """The evaluation's arguments in one batched datagen step of ``b`` maps
    (clouds from make_batch_clouds) after two steps and aging."""
    from elevation_mapping_cupy_torch.nn.traversability import DEFAULT_WEIGHT_FILE, load_weights_npz
    from elevation_mapping_cupy_torch.parallel import batched_update, init_batch
    from elevation_mapping_cupy_torch.runtime import datagen

    cfg = cfg.replace(max_points=n_points)
    w = load_weights_npz(DEFAULT_WEIGHT_FILE).to(card)
    pts, t, _ = datagen.make_batch_clouds(datagen.make_generator(1, card), b, cfg.cell_n, cfg.resolution, n_points)
    mask = torch.ones((b, n_points), dtype=torch.bool, device=card)
    R = torch.eye(3, device=card).expand(b, 3, 3).contiguous()
    z = torch.zeros(b, device=card)
    states = init_batch(cfg, b, card)
    for _ in range(2):
        states = batched_update(states, pts, mask, R, t, z, z, w, cfg)
    for _ in range(7):
        states = core.update_time(states, cfg)
    calls = _capture_polar(monkeypatch)
    pts2, t2, _ = datagen.make_batch_clouds(datagen.make_generator(2, card), b, cfg.cell_n, cfg.resolution, n_points)
    batched_update(states, pts2, mask, R, t2, z, z, w, cfg)
    assert len(calls) == 1
    return calls[0]


def _float_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _assert_evaluation_equal(args) -> torch.Tensor:
    """One launch of the kernel against the plain version on the card:
    channels 5 and 6 (the upper bound and its flag) and the copied ones bit
    for bit, 1 and 2 (their sums over S run in another order) within 1e-5 of
    max(1, |plain|). Returns the kernel's output."""
    before = raycast.KERNEL.launches
    got = _POLAR_EVALUATE(*args)
    assert raycast.KERNEL.launches == before + 1
    want = raycast._polar_evaluate_in_chunks(*args)
    for c in (0, 3, 4, 5, 6):
        assert torch.equal(_float_bits(got[:, c]), _float_bits(want[:, c])), f"channel {c}"
    for c in (1, 2):
        err = (got[:, c].double() - want[:, c].double()).abs() / want[:, c].double().abs().clamp(min=1.0)
        assert float(err.max()) <= 1e-5, f"channel {c}: {float(err.max())}"
    return got


def _assert_the_kernel_works(layers, got, args):
    """The case reached every branch: cells hit, cells given an upper
    bound, cells left alone."""
    changed = got[:, 2] != layers[:, 2]
    bounded = (got[:, 6] == 1.0) & (layers[:, 6] < 0.5)
    assert int(changed.sum()) > 0 and int(bounded.sum()) > 0 and int((~changed).sum()) > 0


@pytest.mark.parametrize("pyramid", [False, True])
def test_polar_kernel_matches_plain_version_on_the_robot_map(card, monkeypatch, pyramid):
    """B = 1 at the deployed config (202x202 cells, R 355), with the
    min-slope pyramid or without."""
    cfg = torch_scenes.deployed_config().replace(raycast_slope_from_bins=not pyramid)
    args = _robot_evaluation(monkeypatch, cfg)
    assert (args[-2][0], args[-2][1], args[-2][2]) == (512, 355, 128) and (args[6] is None) != pyramid
    _assert_the_kernel_works(args[0], _assert_evaluation_equal(args), args)


@pytest.mark.parametrize("b, pyramid", [(8, False), (8, True), (64, False)])
def test_polar_kernel_matches_plain_version_on_datagen_batches(card, monkeypatch, b, pyramid):
    """B = 8 and 64 maps at the default MapConfig (R 72)."""
    args = _batch_evaluation(monkeypatch, MapConfig(raycast_slope_from_bins=not pyramid), b, card)
    assert args[0].shape[0] == b and args[-2][1] == 72
    _assert_the_kernel_works(args[0], _assert_evaluation_equal(args), args)


@pytest.mark.parametrize("pyramid", [False, True])
@pytest.mark.parametrize("bins", [36, 45])
def test_polar_kernel_at_elevation_bins_not_a_multiple_of_32(card, monkeypatch, bins, pyramid):
    """S = 36 (float4 rows, lanes left idle) and 45 (scalar rows) on the
    small map."""
    cfg = MapConfig(**SMALL_KW, raycast_elevation_bins=bins, raycast_slope_from_bins=not pyramid)
    args = _robot_evaluation(monkeypatch, cfg, n_points=8192)
    assert args[-2][2] == bins
    _assert_the_kernel_works(args[0], _assert_evaluation_equal(args), args)


@pytest.mark.parametrize("pyramid", [False, True])
@pytest.mark.parametrize("rows, cols", [((0, 101), (0, 202)), ((57, 61), (33, 120)), ((150, 52), (140, 62))])
def test_polar_kernel_on_blocks_of_a_sharded_map(card, monkeypatch, rows, cols, pyramid):
    """The layers of a block of the robot's map (whole rows, an inner tile,
    a tile at the map's corner) with the whole map's cube: against the plain
    version on the block, and bit for bit against the whole map's launch
    there."""
    cfg = torch_scenes.deployed_config().replace(raycast_slope_from_bins=not pyramid)
    args = _robot_evaluation(monkeypatch, cfg)
    layers, normal, ic, t, pref, total, pyr, geo, _ = args
    n = cfg.cell_n
    block = Block(rows[0], cols[0], rows[1], cols[1], n, n)
    rs, cs = slice(rows[0], rows[0] + rows[1]), slice(cols[0], cols[0] + cols[1])
    sub = (layers[..., rs, cs].contiguous(), normal[..., rs, cs].contiguous(), ic[..., rs, cs].contiguous(), t,
           pref, total, pyr, geo[:4] + (block,), cfg)
    got = _assert_evaluation_equal(sub)
    whole = _POLAR_EVALUATE(*args)
    assert torch.equal(_float_bits(got), _float_bits(whole[..., rs, cs]))


def test_polar_kernel_launches_once_per_update_and_per_step(card):
    """KERNEL.launches (D2) rises by one per polar update (one per
    ``raycast.polar_evaluate`` span) and per batched step at any B, and not
    on the exact path; so does SCAN_KERNEL.launches (D3, one per
    ``raycast.polar_cube`` span), which also rises by one per call of its
    wrapper, whose two passes are one call."""
    import time

    from elevation_mapping_cupy_torch import tracing
    from elevation_mapping_cupy_torch.nn.traversability import DEFAULT_WEIGHT_FILE, load_weights_npz
    from elevation_mapping_cupy_torch.parallel import batched_update, init_batch

    before = raycast.SCAN_KERNEL.launches
    for _ in range(3):
        raycast.polar_scan(torch.ones((2, 2, 16, 9, 12), device=card))
    assert raycast.SCAN_KERNEL.launches == before + 3
    cfg = MapConfig(**SMALL_KW, raycast_mode="polar")
    w = load_weights_npz(DEFAULT_WEIGHT_FILE).to(card)
    rng = np.random.default_rng(6)
    kernels_ = (raycast.KERNEL, raycast.SCAN_KERNEL)
    counts = {}
    for mode in ("polar", "exact"):
        em = ElevationMap(cfg.replace(raycast_mode=mode))
        t0 = time.perf_counter_ns()
        before = [k.launches for k in kernels_]
        for k in range(3):
            R, t, pos = torch_scenes.robot_pose(4 * k)
            em.move_to(pos, R)
            em.input_pointcloud(torch_scenes.scene_cloud(rng, 6000, R, t, r_max=2.5), ["x", "y", "z"], R, t, 0.0, 0.0)
        torch.cuda.synchronize()
        spans = [len([s for s in tracing.spans(t0) if s.name == name])
                 for name in ("raycast.polar_evaluate", "raycast.polar_cube")]
        counts[mode] = [k.launches - n for k, n in zip(kernels_, before)] + spans
    assert counts == {"polar": [3, 3, 3, 3], "exact": [0, 0, 0, 0]}
    for b in (1, 5):
        states = init_batch(cfg, b, card)
        pts = torch.from_numpy(torch_scenes.scene_cloud(rng, 6000, *torch_scenes.robot_pose(0)[:2])).to(card)
        pts = pts.expand(b, -1, -1).contiguous()
        mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=card)
        R = torch.eye(3, device=card).expand(b, 3, 3).contiguous()
        t = torch.tensor([0.0, 0.0, 0.7], device=card).expand(b, 3).contiguous()
        z = torch.zeros(b, device=card)
        before = [k.launches for k in kernels_]
        for _ in range(2):
            states = batched_update(states, pts, mask, R, t, z, z, w, cfg)
        assert [k.launches - n for k, n in zip(kernels_, before)] == [2, 2]


# ---------------------------------------------------------------------------
# the polar cube's scans (csrc/polar_scan.cu)
# ---------------------------------------------------------------------------

_POLAR_SCAN = raycast.polar_scan


def _capture_cubes(monkeypatch) -> list:
    """Records a copy of the cube of every ``raycast.polar_scan`` call; each
    call goes on to the kernel."""
    cubes = []

    def spy(c):
        cubes.append(c.clone())
        return _POLAR_SCAN(c)

    monkeypatch.setattr(raycast, "polar_scan", spy)
    return cubes


def _assert_scan_equal(cubes) -> torch.Tensor:
    """One call of the kernel against the plain version on the card, bit for
    bit. Returns the kernel's output."""
    before = raycast.SCAN_KERNEL.launches
    got = _POLAR_SCAN(cubes)
    assert raycast.SCAN_KERNEL.launches == before + 1
    want = raycast._polar_scan(cubes)
    assert got.shape == want.shape and torch.equal(_float_bits(got), _float_bits(want))
    return got


def test_polar_scan_kernel_matches_plain_version_on_the_robot_cube(card, monkeypatch):
    """B = 1 at the deployed config (A 512, R 355, S 128), on the cube K1
    bins from one update of the smoke scene's 131072 points."""
    cubes = _capture_cubes(monkeypatch)
    em = ElevationMap(torch_scenes.deployed_config())
    R, t, pos = torch_scenes.robot_pose(0)
    em.move_to(pos, R)
    em.input_pointcloud(torch_scenes.scene_cloud(np.random.default_rng(9), torch_scenes.MAIN_POINTS, R, t),
                        ["x", "y", "z"], R, t, 0.0, 0.0)
    assert len(cubes) == 1 and tuple(cubes[0].shape) == (1, 2, 512, 355, 128)
    assert float(cubes[0][:, 0].sum()) > 0.5 * torch_scenes.MAIN_POINTS
    _assert_scan_equal(cubes[0])


@pytest.mark.parametrize("b", [8, 64])
def test_polar_scan_kernel_matches_plain_version_on_datagen_batches(card, monkeypatch, b):
    """B = 8 and 64 maps at the default MapConfig (R 72), on the cubes K1
    bins from one batched step of make_batch_clouds' terrains."""
    from elevation_mapping_cupy_torch.nn.traversability import default_weights
    from elevation_mapping_cupy_torch.parallel import batched_update, init_batch
    from elevation_mapping_cupy_torch.runtime import datagen

    n_points = 100_000
    cfg = MapConfig(max_points=n_points)
    pts, t, _ = datagen.make_batch_clouds(datagen.make_generator(3, card), b, cfg.cell_n, cfg.resolution, n_points)
    mask = torch.ones((b, n_points), dtype=torch.bool, device=card)
    R = torch.eye(3, device=card).expand(b, 3, 3).contiguous()
    z = torch.zeros(b, device=card)
    cubes = _capture_cubes(monkeypatch)
    batched_update(init_batch(cfg, b, card), pts, mask, R, t, z, z, default_weights().to(card), cfg)
    assert len(cubes) == 1 and tuple(cubes[0].shape) == (b, 2, 512, 72, 128)
    assert bool((cubes[0][:, 0].flatten(1).sum(1) > 0).all())
    _assert_scan_equal(cubes[0])


@pytest.mark.parametrize("bins", [36, 45])
def test_polar_scan_kernel_at_elevation_bins_not_a_multiple_of_32(card, monkeypatch, bins):
    """S = 36 and 45 on the small map's cube of one update."""
    cubes = _capture_cubes(monkeypatch)
    em = ElevationMap(MapConfig(**SMALL_KW, raycast_mode="polar", raycast_elevation_bins=bins))
    R, t, pos = torch_scenes.robot_pose(0)
    em.move_to(pos, R)
    em.input_pointcloud(torch_scenes.scene_cloud(np.random.default_rng(2), 6000, R, t, r_max=2.5), ["x", "y", "z"],
                        R, t, 0.0, 0.0)
    assert len(cubes) == 1 and cubes[0].shape[-1] == bins and float(cubes[0].sum()) > 0
    _assert_scan_equal(cubes[0])


@pytest.mark.parametrize("shape", [(3, 37, 5, 45), (2, 17, 1, 7), (1, 1, 33, 2), (5, 16, 16, 32)])
def test_polar_scan_kernel_on_random_cubes(card, shape):
    """Sums of arbitrary floats at shapes no config gives (A, R and S off
    the kernel's chunk of 8 and a warp's 32): any other order of the adds
    would show. (At B = A = S = 1 the plain version's cumsum along R takes
    cub's parallel scan, which adds in another order.)"""
    b, A, R, S = shape
    g = torch.Generator(device=card).manual_seed(sum(shape))
    _assert_scan_equal(torch.rand((b, 2, A, R, S), generator=g, device=card) * 3.7)


def test_polar_scan_kernel_on_empty_and_single_ray_cubes(card):
    """An all-zero cube gives zeros; a cube of one ray in bin (a, r, s)
    gives its count and 1/length at every azimuth from a on and every radius
    up to r, and zero elsewhere."""
    A, R, S = 512, 72, 128
    zero = torch.zeros((2, 2, A, R, S), device=card)
    assert not bool(_assert_scan_equal(zero).any())
    a, r, s = 300, 40, 77
    one = torch.zeros((1, 2, A, R, S), device=card)
    one[0, 0, a, r, s] = 1.0
    one[0, 1, a, r, s] = 1.0 / 1.37
    got = _assert_scan_equal(one)
    want = torch.zeros((1, A, R, 2 * S), device=card)
    want[0, a:, :r + 1, s] = 1.0
    want[0, a:, :r + 1, S + s] = 1.0 / 1.37
    assert torch.equal(got, want)
    assert _POLAR_SCAN(torch.zeros((0, 2, A, R, S), device=card)).shape == (0, A, R, 2 * S)


def test_update_on_card_matches_cpu(card):
    """Three updates of the smoke scene on a small map, on the card and on
    the CPU: K1 three times, K2 never, D1, D2, D4 and D5 once an update, and
    every layer within 1e-4."""
    cfg = MapConfig(resolution=0.1, map_length=4.0, max_ray_length=1.5, max_points=8192, raycast_mode="polar")
    gpu, cpu = ElevationMap(cfg), ElevationMap(cfg, device="cpu")
    rng = np.random.default_rng(3)
    before = _counts()
    for k in range(3):
        R, t, pos = torch_scenes.robot_pose(4 * k)
        pts = torch_scenes.scene_cloud(rng, 6000, R, t, r_max=2.5)
        for em in (gpu, cpu):
            em.move_to(pos, R)
            em.input_pointcloud(pts, ["x", "y", "z"], R, t, 0.0, 0.0)
    _launched(before, 3, 0, 1, 1, 1, times=3)
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
        R, t, pos = torch_scenes.robot_pose(k)
        em.move_to(pos, R)
        em.input_pointcloud(torch_scenes.scene_cloud(rng, n_points, R, t), ["x", "y", "z"], R, t, 0.0, 0.0)
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
        cfg, n_rays = torch_scenes.deployed_config().replace(raycast_mode="exact"), 131072
    state = _aged_map(cfg, n_rays)
    pack, world, valid, t, gate = torch_scenes.march_inputs(
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


@pytest.mark.parametrize("gated", [True, False])
def test_march_kernel_on_blocks_matches_plain_version(card, gated):
    """K2 with block bounds (two row blocks and a tile of the deployed map,
    as a sharded map's processes launch it) against its plain version on
    the same block, and against the unblocked launch there: hit counts and
    upper bounds equal, the decrement within 2e-4; with the whole map as
    its block the launch is the unblocked one."""
    from elevation_mapping_cupy_torch.ops.geometry import Block

    cfg = torch_scenes.deployed_config().replace(raycast_mode="exact")
    state = _aged_map(cfg, 131072)
    pack, world, valid, t, gate = torch_scenes.march_inputs(state, cfg, 131072, np.random.default_rng(9), gated, pose=3)
    whole = cuda_march.exact_march(pack, world, valid, t, cfg, gate)
    n = cfg.cell_n
    same = cuda_march.exact_march(pack, world, valid, t, cfg, gate, Block.whole(n, n))
    _assert_march_equal(same, whole, gated)
    for blk in (Block(0, 0, 108, n, n, n), Block(94, 0, 108, n, n, n), Block(94, 94, 108, 108, n, n)):
        res = torch_scenes.check_block_march(state, cfg, world, valid, t, blk, gated, whole, f"block {blk}")
        assert res["ub_cells"] > 0


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
@pytest.mark.parametrize("size", sorted(torch_scenes.SPATIAL_WORLDS))
def test_spatial_worlds_match_unsharded(card, size, backend):
    """One map sharded over a world of 2 processes (rows) or 4 (2x2 tiles):
    gloo carries the halos through host memory with every process on one
    card, NCCL card to card with one process a card (it skips without as
    many cards). K1 and K2 checked at the blocks' shapes, every process
    launching the kernels as the path must, and each config's gathered map
    and sharded move_to within 1e-5 of the unsharded update on card 0 (99.9 %
    of cells)."""
    from elevation_mapping_cupy_torch.nn.traversability import DEFAULT_WEIGHT_FILE, load_weights_npz

    if backend == "nccl" and torch.cuda.device_count() < size:
        pytest.skip(f"needs {size} cards: NCCL takes one rank a card")
    rng = np.random.default_rng(0)
    pcfg = torch_scenes.spatial_configs()["polar1024"][0]
    bins = pcfg.azimuth_bins * (pcfg.n_ray_steps + 2) * pcfg.raycast_elevation_bins
    cube = torch_scenes.check_scatter_case(rng, "spatial polar cube", 1, torch_scenes.MAIN_POINTS, bins, (True, False))
    checked = torch_scenes.checked_shapes(torch_scenes.spatial_k1_cases(rng) + [cube[0]])
    cfg = torch_scenes.deployed_config().replace(raycast_mode="exact")
    march_checked = torch_scenes.march_block_shapes(torch_scenes.check_march_blocks(_aged_map(cfg, 131072), cfg, rng))
    w = load_weights_npz(DEFAULT_WEIGHT_FILE).to(card)
    refs = {name: torch_scenes.spatial_reference(name, c, n, w) for name, (c, n) in torch_scenes.spatial_configs().items()}
    reports, maps = torch_scenes.run_spatial_world(size, backend)
    torch_scenes.check_spatial_world(size, reports, maps, refs, checked, march_checked)


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
    pack, world, valid, t, gate = torch_scenes.march_inputs(state, cfg, 4096, np.random.default_rng(10), True, pose=3)
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
    """Three exact-march updates on the card and on the CPU: K1 twice, K2,
    D1, D4 and D5 once and D2 never per update, and every layer within
    1e-4."""
    cfg = MapConfig(**SMALL_KW, raycast_mode="exact")
    gpu, cpu = ElevationMap(cfg), ElevationMap(cfg, device="cpu")
    rng = np.random.default_rng(11)
    before = _counts()
    for k in range(3):
        R, t, pos = torch_scenes.robot_pose(4 * k)
        pts = torch_scenes.scene_cloud(rng, 6000, R, t, r_max=2.5)
        for em in (gpu, cpu):
            em.move_to(pos, R)
            em.input_pointcloud(pts, ["x", "y", "z"], R, t, 0.0, 0.0)
            em.update_time()
    _launched(before, 2, 1, 1, 0, 1, times=3)
    names = ["elevation", "variance", "is_valid", "traversability", "upper_bound", "is_upper_bound", "normal_z"]
    got, want = gpu.get_layers(names), cpu.get_layers(names)
    for name in names:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4, err_msg=name)


def test_replay_on_card_matches_cpu(card, tmp_path):
    """A 3-frame log of the deployed map replayed with the exact march (353
    steps x 20000 rays: the router's gated and flat marches) on the card and
    on the CPU: K1 twice, K2, D1, D4 and D5 once and D2 never a frame, and every
    frame's layers within 1e-4 on 99.9 % of cells."""
    from elevation_mapping_cupy_torch.runtime.replay import LogWriter, replay

    rng = np.random.default_rng(6)
    log = LogWriter(["x", "y", "z"])
    for k in range(3):
        R, t, pos = torch_scenes.robot_pose(2 * k)
        log.add(torch_scenes.scene_cloud(rng, 20000, R, t), R, t, position=pos, stamp=0.1 * k)
    path = str(tmp_path / "log.npz")
    log.save(path)
    cfg, kw = torch_scenes.deployed_config(), dict(snapshot_layers=torch_scenes.LAYERS, raycast_mode="exact")
    before = _counts()
    got = replay(path, cfg, device="cuda", **kw)
    _launched(before, 2, 1, 1, 0, 1, times=3)
    for i, (g, c) in enumerate(zip(got, replay(path, cfg, device="cpu", **kw))):
        torch_scenes.compare_layers(f"replay frame {i}", g, c)


def test_profile_on_card_matches_cpu(card):
    """The profile entry point on the card (10 iterations of 100000 points
    at the default MapConfig): K1 five times (geometry 3, colour, and
    class_bayesian), D1, D2, D4 and D5 once and K2 never an update, its warm-up
    included. Then one update of its map on the card and the CPU from the
    same state: layers within 1e-4 (the colour bit for bit), sem_new within
    1e-4 of max(1, |sum|) and id_max bit for bit, on 99.9 % of cells."""
    from elevation_mapping_cupy_torch import profile
    from elevation_mapping_cupy_torch.state import state_from_numpy, state_to_numpy

    before = _counts()
    assert profile.main(["--iters", "10", "--points", "100000"])
    _launched(before, 5, 0, 1, 1, 1, times=11)
    cfg = profile.profile_config(100_000)
    rng = np.random.default_rng(123)
    R = np.eye(3, dtype=np.float32)
    gpu, cpu = ElevationMap(cfg), ElevationMap(cfg, device="cpu")
    first = profile.make_points(rng, 100_000)
    for em in (gpu, cpu):  # the first update grows the semantic layers
        em.input_pointcloud(first, profile.CHANNELS, R, np.array([0.0, 0.0, 0.6], np.float32), 0.0, 0.0)
    gpu.move_to(np.array([0.01, 0.02, 0.01]), R)
    cpu.state = state_from_numpy(state_to_numpy(gpu.state), "cpu")
    pts = profile.make_points(rng, 100_000)
    for em in (gpu, cpu):
        em.input_pointcloud(pts, profile.CHANNELS, R, np.array([0.01, 0.02, 0.6], np.float32), 0.0, 0.0)
    names = torch_scenes.LAYERS + list(gpu.cfg.semantic_layers)
    torch_scenes.compare_layers("profile", gpu.get_layers(names), cpu.get_layers(names), packed=("rgb",))
    fields = [_state_rows(em.state, em.cfg) for em in (gpu, cpu)]
    torch_scenes.compare_layers("profile", *fields, packed=[f"id_max:{n}" for n in gpu.cfg.semantic_layers],
                                 sums=[f"sem_new:{n}" for n in gpu.cfg.semantic_layers])


# ---------------------------------------------------------------------------
# semantic layers and the image path
# ---------------------------------------------------------------------------

def _state_rows(state, cfg) -> dict:
    """sem_new and id_max rows by layer name as host arrays (id_max as the
    float32 with its bits)."""
    sem_new, ids = state.sem_new.cpu().numpy(), state.id_max.cpu().numpy().astype(np.uint32)
    out = {f"sem_new:{name}": sem_new[i] for i, name in enumerate(cfg.semantic_layers)}
    out.update({f"id_max:{name}": ids[i].view(np.float32) for i, name in enumerate(cfg.semantic_layers)})
    return out


@pytest.mark.parametrize("points", [20000, torch_scenes.MAIN_POINTS])
@pytest.mark.parametrize("table", ["semantic_mem", "all_fusions"])
def test_semantic_maps_on_card_match_cpu(card, table, points):
    """Four updates of ``points`` points (20000, and the robot's 131072)
    on the deployed map with
    semantic_mem.yaml's table (rgb -> color, three class channels ->
    class_average: K1 five times an update) or with average,
    bayesian_inference, class_bayesian and two class_max channels (seven
    times, class_max over 32 x 202 x 202 bins on K1's global path); the
    last rerun on the CPU from the same state: float layers and sem_new
    within 1e-4 (sem_new of max(1, |sum|)), the colour and the class ids bit
    for bit, on 99.9 % of cells. The packed layers survive a state round
    trip through NumPy and a shift on the card as on the CPU."""
    from elevation_mapping_cupy_torch.state import state_from_numpy, state_to_numpy

    if table == "semantic_mem":
        cfg, make, channels, k1 = torch_scenes.semantic_config(), torch_scenes.mem_cloud, torch_scenes.MEM_CHANNELS, 5
    else:
        cfg = torch_scenes.deployed_config().replace(semantic_layers=torch_scenes.ALL_FUSIONS_CHANNELS,
                                                     pointcloud_channel_fusions=torch_scenes.ALL_FUSIONS_TABLE)
        make, channels, k1 = torch_scenes.all_fusions_cloud, torch_scenes.ALL_FUSIONS_CHANNELS, 7
        assert cuda_scatter.launch_plan(1, 1, 2 * points, 32 * cfg.cell_n ** 2).path == "global"
    names = ["x", "y", "z"] + list(channels)
    gpu, cpu = ElevationMap(cfg), ElevationMap(cfg, device="cpu")
    rng = np.random.default_rng(7)
    before = _counts()
    for k in range(4):
        R, t, pos = torch_scenes.robot_pose(2 * k)
        gpu.move_to(pos, R)
        cloud = make(rng, points, R, t)
        if k == 3:
            cpu.state = state_from_numpy(state_to_numpy(gpu.state), "cpu")
            cpu.input_pointcloud(cloud, names, R, t, 0.0, 0.0)
        gpu.input_pointcloud(cloud, names, R, t, 0.0, 0.0)
    _launched(before, k1, 0, 1, 1, 1, times=4)
    layers = torch_scenes.LAYERS + list(cfg.semantic_layers)
    packed = ("rgb",) if table == "semantic_mem" else ()
    torch_scenes.compare_layers(table, gpu.get_layers(layers), cpu.get_layers(layers), packed=packed)
    torch_scenes.compare_layers(table, _state_rows(gpu.state, cfg), _state_rows(cpu.state, cfg),
                                 packed=[f"id_max:{n}" for n in cfg.semantic_layers],
                                 sums=[f"sem_new:{n}" for n in cfg.semantic_layers])
    if table == "all_fusions":
        ids = gpu.state.id_max[3:].unique().tolist()
        assert set(ids) <= set(range(9)) and len(ids) >= 8  # the clouds hold ids 1..8
        return
    arrays = state_to_numpy(gpu.state)
    again = state_from_numpy(arrays, "cuda")
    assert np.array_equal(_bits(again.semantic), _bits(gpu.state.semantic)) and torch.equal(again.id_max, gpu.state.id_max)
    moved, moved_cpu = core.shift_map_xy(gpu.state, 5, -3, cfg), core.shift_map_xy(state_from_numpy(arrays, "cpu"), 5, -3, cfg)
    for field in ("semantic", "sem_new", "id_max"):
        a, b = getattr(moved, field).cpu(), getattr(moved_cpu, field)
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b), field


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
    idx = torch.from_numpy(torch_scenes.cell_indices(rng, 1, n, 202 * 202)).to(card)
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
    colour = torch.from_numpy(torch_scenes.pack_rgb(rng.integers(0, 256, (50000, 3))))
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
        R, t, pos = torch_scenes.robot_pose(4 * k)
        n = 6000
        cloud = np.concatenate([
            torch_scenes.scene_cloud(rng, n, R, t, r_max=2.5),
            torch_scenes.pack_rgb(rng.integers(0, 256, (n, 3)))[:, None],
            rng.uniform(-1, 1, (n, 4)).astype(np.float32),
            torch_scenes.pack_class(rng.uniform(0.2, 1, (n, 2)).astype(np.float32), rng.integers(1, 41, (n, 2))),
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


@pytest.mark.parametrize("width", ["small", "deployed"])
@pytest.mark.parametrize("mode", ["shadow", "bresenham"])
def test_input_image_on_card_matches_cpu(card, mode, width):
    """One image onto a mapped state, on the card and on the CPU: neither
    kernel is launched; valid agrees on 99.5 % of cells and the fused
    layers on the cells valid in both. "small": a 48x64 image with lens
    distortion on a 4 m map; "deployed": a 480x640 image from 1.5 m above a
    point 0.6 m ahead of the robot on the deployed map of one 131072-point
    cloud."""
    if width == "small":
        cfg = MapConfig(**SMALL_KW, raycast_mode="polar", image_occlusion_mode=mode)
        (H, W), f, n, r_max = (48, 64), 20.0, 8000, 2.5
        D = np.array([0.01, -0.005, 0.001, 0.0005, 0.0], np.float32)
    else:
        cfg = torch_scenes.deployed_config().replace(image_occlusion_mode=mode)
        (H, W), f, n, r_max = torch_scenes.IMAGE_SHAPE, 400.0, torch_scenes.MAIN_POINTS, 6.0
        D = np.zeros(5, np.float32)
    gpu, cpu = ElevationMap(cfg), ElevationMap(cfg, device="cpu")
    rng = np.random.default_rng(23)
    R, t, pos = torch_scenes.robot_pose(0)
    cloud = torch_scenes.scene_cloud(rng, n, R, t, r_max=r_max)
    img = np.concatenate([rng.integers(0, 256, (3, H, W)), rng.random((1, H, W))]).astype(np.float32)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    Rc = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    tc = np.array([0.1, 0.05, 1.3], np.float32)
    if width == "deployed":
        tc = (-Rc @ (gpu.center + np.array([0.6, -0.2, 1.5]))).astype(np.float32)
    before = (cuda_scatter.KERNEL.launches, cuda_march.KERNEL.launches)
    valid = {}
    for em in (gpu, cpu):
        em.input_pointcloud(cloud, ["x", "y", "z"], R, t, 0.0, 0.0)
        args = [torch.as_tensor(a, device=em.device) for a in (Rc, tc, K, D)]
        valid[em.device.type] = core.image_correspondence(em.state, H, W, *args, cfg)[1].cpu().numpy()
        em.input_image(img, ["rgb", "mask"], Rc, tc, K, D)
    assert (cuda_scatter.KERNEL.launches, cuda_march.KERNEL.launches) == (before[0] + 3, before[1])
    assert (valid["cuda"] == valid["cpu"]).mean() >= 0.995
    assert valid["cpu"].sum() > max(300, 0.02 * cfg.cell_n ** 2)
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

    cfg = torch_scenes.semantic_config().replace(resolution=0.1, map_length=6.0, max_ray_length=2.0, max_points=8192)
    gpu = ElevationMap(cfg)
    rng = np.random.default_rng(30)
    names = ["x", "y", "z"] + list(torch_scenes.MEM_CHANNELS)
    for k in range(frames):
        R, t, pos = torch_scenes.robot_pose(3 * k)
        gpu.move_to(pos, R)
        gpu.input_pointcloud(torch_scenes.mem_cloud(rng, 6000, R, t), names, R, t, 0.0, 0.0)
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
    float layers within 1e-4 on 99.9 % of cells with NaN where the CPU has
    NaN, semantic_filter bit for bit, features_pca channel by channel equal
    or mirrored; no kernel launched."""
    gpu, cpu = _semantic_map_pair(card)
    settings = torch_scenes.PLUGIN_SETTINGS + torch_scenes.SEMANTIC_PLUGIN_SETTINGS
    for em in (gpu, cpu):
        em.plugin_manager.init(*torch_scenes.plugin_settings(settings))
    names = gpu.plugin_manager.layer_names
    assert len(names) == 10 and gpu.plugin_manager.layers.device.type == "cuda"
    before = (cuda_scatter.KERNEL.launches, cuda_march.KERNEL.launches)
    got, want = gpu.get_layers(names), cpu.get_layers(names)
    torch.cuda.synchronize()
    assert (cuda_scatter.KERNEL.launches, cuda_march.KERNEL.launches) == before
    stats = torch_scenes.compare_plugin_layers("plugins", got, want)
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
    pts = torch_scenes.INIT_POINTS * 0.6 + gpu.center
    before = _counts()
    for em in (gpu, cpu):
        em.initialize_map(pts, "linear")
    _launched(before, 0, 0, 2, 0, 0)  # it dilates twice at dilation_size_initialize
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
    return torch_scenes.planeseg_scene(np.random.default_rng(0))


@pytest.mark.parametrize("b, k", [(1, 10), (1, 1), (16, 10)])
def test_kernel_at_the_planeseg_shapes(card, b, k):
    """K1 at extract_planes' shapes (10 moment streams or the bad-cell
    count over 65 bins, ~70 % of the cells on one bin) against its plain
    version: counts bit for bit, values within 2e-4 relative."""
    labels = torch.from_numpy(torch_scenes.planeseg_labels(_planeseg_scene())).reshape(1, -1).to(torch.int32)
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
    1e-5), and update_batch (two K1 launches) against update on the card."""
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
    before = _counts()
    batch = pipe.update_batch(maps)
    _launched(before, 2, 0, 0, 0, 0)
    for b, t in enumerate(batch):
        np.testing.assert_array_equal(t.labels, pipe.update(maps[b]).labels)


# ---------------------------------------------------------------------------
# batched multi-map updates (parallel/, runtime/datagen.py)
# ---------------------------------------------------------------------------

def test_batched_step_on_card_matches_per_map(card):
    """A batched step of 4 maps at the default MapConfig (clouds from
    make_batch_clouds on the card) launches K1 three times, D1, D2, D4 and
    D5 once and K2 never, and equals each map's own update on the card within 1e-5
    and the CPU port's batched step within 1e-4, on 99.9 % of cells."""
    from elevation_mapping_cupy_torch.nn.traversability import DEFAULT_WEIGHT_FILE, load_weights_npz
    from elevation_mapping_cupy_torch.parallel import batched_update, init_batch
    from elevation_mapping_cupy_torch.runtime import datagen
    from elevation_mapping_cupy_torch.state import MapState, state_to_numpy, take_map

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
    before = _counts()
    out = batched_update(states, pts, mask, R, t, z, z, w, cfg)
    _launched(before, 3, 0, 1, 1, 1)
    assert float((out.layers[:, 2] > 0.5).float().mean()) > 0.02
    on_cpu = batched_update(MapState(*(x.cpu() for x in states)), *(x.cpu() for x in (pts, mask, R, t, z, z)),
                            load_weights_npz(DEFAULT_WEIGHT_FILE), cfg)
    torch_scenes.share_within("batch on the CPU", state_to_numpy(out), state_to_numpy(on_cpu),
                               torch_scenes.CMP_ATOL, torch_scenes.CMP_MIN_SHARE)
    for b in range(B):
        one = core.update_pointcloud(take_map(states, b), pts[b], mask[b], R[b], t[b], 0.0, 0.0, w, cfg)
        for name, x, y in zip(out._fields, take_map(out, b), one):
            close = ((x.double() - y.double()).abs() <= 1e-5).float().mean() if x.numel() else 1.0
            assert float(close) >= 0.999, f"map {b} {name}: {float(close)}"


@pytest.mark.parametrize("b, aged", [(8, True), (64, False), (64, True)])
def test_march_kernel_on_a_batch_matches_plain_version_and_each_map(card, b, aged):
    """K2 on a datagen batch of 100000 rays a map (the cell
    datagen_exact.b64_ep8's widths), one launch for every map, against its
    plain version and against one launch a map: hit counts, upper bounds
    and segment counts equal, the decrement within 2e-4 relative to
    max(1, |sum|) (float atomics add a cell's decrements in any order).
    On fresh maps nothing is old enough to be hit (and at this density no
    ray crosses an invalid cell); maps of 8 steps, aged, are hit."""
    cfg, _, _, (pack, world, valid, t, gate), _ = torch_scenes.datagen_exact_step(
        b, 100000, card, steps=8 if aged else 1, aged=aged)
    assert gate is not None and pack.shape == (b, cfg.cell_n**2, cuda_march.PACK_WIDTH)
    before = cuda_march.KERNEL.launches
    got = cuda_march.exact_march(pack, world, valid, t, cfg, gate)
    torch.cuda.synchronize()
    assert cuda_march.KERNEL.launches == before + 1
    want = cuda_march.exact_march_reference(pack, world, valid, t, cfg, gate)
    _assert_march_equal(got, want, True)
    assert (float(want.hits.sum()) > 0) == aged and (bool(torch.isfinite(want.ubmin).any()) or not aged)
    assert bool((got.counts[:, 0] < got.counts[:, 1]).all()) and bool((got.counts[:, 0] > 0).all())
    for m in range(b):
        own = cuda_march.exact_march(pack[m], world[m], valid[m], t[m], cfg, gate._replace(table=gate.table[m]))
        _assert_march_equal(got._replace(**{f: getattr(got, f)[m] for f in got._fields}), own, True)


@pytest.mark.parametrize("b, aged, impl", [(1, True, "gated"), (8, True, "gated"), (8, True, "flat"),
                                           (64, False, "gated"), (64, True, "gated")])
def test_exact_cleanup_in_one_launch_matches_its_parts(card, b, aged, impl):
    """The exact cleanup of a datagen batch of 100000 rays a map in K2's
    one launch (pack, gate, march and update) against the same cleanup
    composed of its parts: every layer but validity and the survivor
    fractions bit for bit, validity within 2e-4 (torch_scenes.
    check_exact_cleanup). Fresh maps are not hit; aged ones are."""
    cfg, _, _, _, snap = torch_scenes.datagen_exact_step(b, 100000, card, steps=8 if aged else 1, aged=aged)
    got, aux = torch_scenes.check_exact_cleanup(cfg.replace(raycast_exact_impl=impl), snap, f"B={b} {impl}")
    layers = snap[0]
    assert bool((got[:, 1] > layers[:, 1]).any()) == aged
    frac = aux["gate_survivor_frac"]
    assert frac.shape == (b,)
    assert bool(((frac > 0) & (frac < 1)).all()) if impl == "gated" else bool((frac == 1).all())


@pytest.mark.parametrize("b", [64, 8])
def test_batched_exact_step_on_card_matches_cpu(card, b):
    """A datagen step of ``b`` maps of 100000 points with the exact cleanup
    (MapConfig(raycast_mode="exact")): K1 twice, K2, D1, D4 and D5 once, D2
    and D3 never, whatever B is; every field within 1e-4 of the CPU port's step on
    99.9 % of cells."""
    from elevation_mapping_cupy_torch.nn.traversability import default_weights
    from elevation_mapping_cupy_torch.parallel import batched_update
    from elevation_mapping_cupy_torch.state import MapState, state_to_numpy

    cfg, args, state, _, _ = torch_scenes.datagen_exact_step(b, 100000, card, steps=8, aged=True)
    before = _counts()
    out = batched_update(state, *args)
    _launched(before, 2, 1, 1, 0, 1)
    on_cpu = batched_update(MapState(*(x.cpu() for x in state)), *(x.cpu() for x in args[:6]), default_weights(),
                            cfg)
    torch_scenes.share_within(f"exact step B={b} on the CPU", state_to_numpy(out), state_to_numpy(on_cpu),
                               torch_scenes.CMP_ATOL, torch_scenes.CMP_MIN_SHARE)


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


@pytest.mark.parametrize("mode", ["shadow", "bresenham"])
def test_batched_input_image_on_card_matches_per_map(card, mode):
    """One image per map of a batch of 4 (rgb and mask layers, every cell
    valid, cameras 2 m up near each map's centre): the batched call equals
    each map's own input_image on the card, the colour bit for bit and the
    mask within 1e-6, on every cell."""
    from elevation_mapping_cupy_torch.parallel import batched_input_image, init_batch
    from elevation_mapping_cupy_torch.state import take_map

    b, (H, W), channels = 4, (240, 320), ("rgb", "mask")
    cfg = MapConfig(image_occlusion_mode=mode, semantic_layers=channels, image_channel_fusions=(
        ("rgb", "color"), ("mask", "exponential"), ("default", "exponential")))
    rng = np.random.default_rng(13)
    maps = init_batch(cfg, b, card)
    maps.layers[:, 0] = torch.from_numpy(rng.normal(0.0, 0.1, (b, cfg.cell_n, cfg.cell_n)).astype(np.float32)).to(card)
    maps.layers[:, 2] = 1.0
    img = np.concatenate([rng.integers(0, 256, (b, 3, H, W)), rng.random((b, 1, H, W))], axis=1).astype(np.float32)
    f = 0.625 * W  # a 3.2 m x 2.4 m footprint from 2 m
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    R = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    centers = maps.center.cpu().numpy()
    ts = np.stack([-R @ (centers[i] + np.array([0.3 * i, -0.2, 2.0], np.float32)) for i in range(b)])
    dev = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=card)  # noqa: E731
    args = (dev(img), dev(np.broadcast_to(R, (b, 3, 3))), dev(ts), dev(np.broadcast_to(K, (b, 3, 3))),
            torch.zeros((b, 5), device=card))
    got = batched_input_image(maps, *args, cfg, channels).semantic
    want = torch.stack([core.input_image(take_map(maps, m), *(a[m] for a in args), cfg, channels).semantic
                        for m in range(b)])
    assert float((got[:, 1] != 0).float().mean()) >= 0.05
    assert torch.equal(_float_bits(got[:, 0]), _float_bits(want[:, 0]))
    assert float((got[:, 1] - want[:, 1]).abs().max()) <= 1e-6


def test_one_process_nccl_group_on_card(card, tmp_path):
    """NCCL on one card: a one-process group, a (1, 1) pod mesh, a batched
    step fed through HostFeed, batch_stats through NCCL's all-reduce equal
    to the no-group values, and a checkpoint round trip bit for bit; the
    group is torn down after."""
    import socket

    from elevation_mapping_cupy_torch.nn.traversability import DEFAULT_WEIGHT_FILE, load_weights_npz
    from elevation_mapping_cupy_torch.parallel import (
        batch_stats, batched_update, checkpoint, distributed, init_batch, shard_states,
    )
    from elevation_mapping_cupy_torch.runtime import datagen

    b, n = 16, 20000
    cfg = MapConfig(max_points=n)
    w = load_weights_npz(DEFAULT_WEIGHT_FILE).to(card)
    pts, t, _ = datagen.make_batch_clouds(datagen.make_generator(0, card), b, cfg.cell_n, cfg.resolution, n)
    inputs = (pts, torch.ones((b, n), dtype=torch.bool), torch.eye(3).expand(b, 3, 3), t, torch.zeros(b))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    assert distributed.initialize(f"localhost:{port}", 1, 0)
    try:
        assert torch.distributed.get_backend() == "nccl"
        mesh = distributed.pod_mesh(("host", "chip"))
        assert tuple(mesh.mesh.shape) == (1, 1) and mesh.device_type == "cuda"
        local = shard_states(init_batch(cfg, b, card), mesh, "host")
        feed = distributed.HostFeed(b, mesh, axis="host")
        fed = [feed.globalize(x.cpu().numpy()) for x in inputs]
        stepped = batched_update(local, *fed, fed[-1], w, cfg)
        stats = {k: float(v) for k, v in batch_stats(stepped).items()}
        checkpoint.save(str(tmp_path), stepped)
        back = checkpoint.restore(str(tmp_path), template=local)
        for name, x, y in zip(stepped._fields, stepped, back):
            assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y), name
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()
    assert stats == {k: float(v) for k, v in batch_stats(stepped).items()} and 0.0 < stats["frac_valid_mean"] < 1.0


def test_service_raw_ingest_on_card_matches_cpu(card):
    """MappingService on the card: raw PointCloud2-style frames through the
    native ring, K1 three times and D1, D2, D4 and D5 once a frame, a publisher of
    the layers, then an image frame (no kernel launch), two submaps and
    CheckSafety. The same through the CPU service: the final map within
    1e-4 on 99.9 % of cells (the colour bit for bit), the same publishes,
    statistics, submaps and safety answer."""
    from elevation_mapping_cupy_torch.runtime.service import MappingService, SensorFrame

    cfg = MapConfig(resolution=0.1, map_length=4.0, max_ray_length=2.0, max_points=8192)
    rng = np.random.default_rng(3)
    frames = []
    for k in range(3):
        R, t, pos = torch_scenes.robot_pose(k)
        frames.append((R, t, pos, torch_scenes.raw_records(torch_scenes.scene_cloud(rng, 8192, R, t, r_max=1.8), rng)))
    img = rng.integers(0, 256, (3, 48, 64)).astype(np.float32)
    K = np.array([[20, 0, 32], [0, 20, 24], [0, 0, 1]], np.float32)
    Rc = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    yaw = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    triangle = np.array([[-0.6, -0.6], [1.3, -0.6], [-0.6, 1.3]], np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        svc = MappingService(cfg, device=dev)
        svc.enable_raw_ingest()
        published = []
        svc.add_publisher("elevation_map_raw", torch_scenes.LAYERS, 5.0, lambda layers: published.append(sorted(layers)))
        before = _counts()
        for k, (R, t, pos, raw) in enumerate(frames):
            svc.update_pose(pos, R)
            assert svc.enqueue_raw_pointcloud(raw, 8192, torch_scenes.POINT_STEP, [0, 4, 8], ["x", "y", "z"], R, t)
            assert svc.spin_once(now=0.1 * (k + 1)) == 1
        if dev == "cuda":
            _launched(before, 3, 0, 1, 1, 1, times=3)
            assert svc.mapper.state.layers.device.type == "cuda"
        c = svc.mapper.center
        before = _counts()
        svc.enqueue(SensorFrame(kind="image", channels=("rgb",), data=img, R=Rc, t=-Rc @ (c + np.array([0.1, 0.05, 1.3])),
                                K=K, D=np.zeros(5, np.float32)))
        svc.spin_once(now=0.5)
        if dev == "cuda":
            _launched(before, 0, 0, 0, 0, 0)
        submaps = {f"submap:{k}": v for k, v in svc.get_submap(c[:2] + 0.5, (2.0, 1.6), ["elevation", "traversability"]).items()}
        submaps.update({f"yawed:{k}": v for k, v in svc.get_submap(
            c[:2], (1.6, 1.6), ["elevation"], frame_transform=(yaw, np.array([0.0, 0.0, 0.5]))).items()})
        (safe, trav, poly), = svc.check_safety([triangle + c[:2]])
        out[dev] = (svc.mapper.get_layers(torch_scenes.LAYERS + ["rgb"]), submaps, (safe, trav, poly.shape), published,
                    (svc.stats.frames_processed, svc.stats.frames_dropped))
    (layers, submaps, safety, published, stats), want = out["cuda"], out["cpu"]
    torch_scenes.compare_layers("service", layers, want[0], packed=("rgb",))
    assert np.count_nonzero(want[0]["rgb"]) > 100
    torch_scenes.compare_layers("service submaps", submaps, want[1])
    assert safety[::2] == want[2][::2] and abs(safety[1] - want[2][1]) <= 1e-4
    assert published == want[3] and published and stats == want[4]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["vit_tiny", "vit_small"])
def test_dino_on_card_matches_cpu(card, variant, dtype):
    """The ViT on the card against the CPU port with the same seeded weights:
    vit_tiny/8 on two 64x48 images, and the sensor's vit_small/8 on one
    224x224 image. float32 tokens and code within 1e-4. bf16: vit_tiny's
    tokens within 2e-2 and code within 5e-3; vit_small's largest and mean
    difference each no larger than the CPU port's own bf16 against its
    float32."""
    from elevation_mapping_cupy_torch.sensor import dino as D

    assert not torch.backends.cuda.matmul.allow_tf32  # float32 products must stay float32
    rng = np.random.default_rng(0)
    if variant == "vit_tiny":
        cfg = D.ViTConfig(variant="vit_tiny", patch_size=8, dim=12, compute_dtype=getattr(torch, dtype))
        img = torch.from_numpy(rng.standard_normal((2, 3, 64, 48)).astype(np.float32))
    else:
        cfg = D.ViTConfig(variant="vit_small", patch_size=8, compute_dtype=getattr(torch, dtype))
        img = torch.from_numpy(rng.standard_normal((1, 3, 224, 224)).astype(np.float32))
    model = D.init_vit_params(torch.Generator().manual_seed(7), cfg)
    run = lambda m, x, c: (D.vit_features(m, x, c)[0], D.dino_featurize(m, x, c)[1])  # noqa: E731
    want = run(model, img, cfg)
    f32 = D.ViTConfig(variant=variant, patch_size=8, dim=cfg.dim, compute_dtype=torch.float32)
    want_f32 = run(D.init_vit_params(torch.Generator().manual_seed(7), f32), img, f32) if dtype == "bfloat16" else None
    got = run(model.to(card), img.to(card), cfg)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.device.type == "cuda" and g.dtype == torch.float32 and g.shape == w.shape
        diff = (g.cpu() - w).abs()
        if dtype == "float32":
            assert float(diff.max()) <= 1e-4
        elif variant == "vit_tiny":
            assert float(diff.max()) <= (2e-2, 5e-3)[i]
        else:
            gap = (w - want_f32[i]).abs()
            assert float(diff.max()) <= float(gap.max()) and float(diff.mean()) <= float(gap.mean())


def test_sensor_node_on_card(card):
    """PointcloudSensorNode with a DINO model on the card: the same cloud as
    the CPU node's (seed 0 weights), DINO channels within 5e-3 at bf16."""
    from elevation_mapping_cupy_torch.sensor.pointcloud import PointcloudParameter, PointcloudSensorNode

    depth, rgb, K, _, _ = torch_scenes.sensor_frame(0)
    depth, rgb = depth[:96, :128], rgb[:, :96, :128]
    param = PointcloudParameter(channels=("a", "b"))
    clouds = [PointcloudSensorNode(param, semantic_model="dino_vits16", device=dev)(depth, K, rgb=rgb)
              for dev in ("cuda", "cpu")]
    (c_gpu, names), (c_cpu, names_cpu) = clouds
    assert names == names_cpu == ["x", "y", "z", "rgb", "a", "b"]
    np.testing.assert_array_equal(c_gpu[:, :4].view(np.uint32), c_cpu[:, :4].view(np.uint32))
    assert np.abs(c_gpu[:, 4:] - c_cpu[:, 4:]).max() <= 5e-3


def test_sensor_node_into_semantic_service_on_card_matches_cpu(card):
    """The semantic sensor path at its deployed width: PointcloudSensorNode
    with dino_vits8 (vit_small/8, bf16) on the card turns 480x640 depth+rgb
    frames into clouds with three DINO channels, which a MappingService on
    semantic_mem.yaml's tables fuses (rgb -> color, the rest ->
    class_average): K1 five times, D1, D2, D4 and D5 once a frame. The same clouds
    through the CPU service give the same map (1e-4 on 99.9 % of cells, the
    colour bit for bit), and each DINO channel covers half the camera's
    footprint."""
    from elevation_mapping_cupy_torch.runtime.service import MappingService, SensorFrame
    from elevation_mapping_cupy_torch.sensor.pointcloud import PointcloudParameter, PointcloudSensorNode

    channels = ("grass", "tree", "person")
    node = PointcloudSensorNode(PointcloudParameter(channels=channels), semantic_model="dino_vits8", device="cuda")
    assert node.model.cfg.variant == "vit_small" and node.model.cfg.compute_dtype == torch.bfloat16
    cfg = torch_scenes.semantic_config()
    services = [MappingService.from_settings(cfg, torch_scenes.DEPLOYED_EXTRAS, device=d) for d in ("cuda", "cpu")]
    before = _counts()
    for k in range(3):
        depth, rgb, K, R, cam = torch_scenes.sensor_frame(k)
        cloud, names = node(depth, K, rgb=rgb)
        assert names == ["x", "y", "z", "rgb", *channels] and np.isfinite(cloud).all()
        for svc in services:
            svc.update_pose(torch_scenes.robot_pose(k)[2], np.eye(3))
            svc.enqueue(SensorFrame(kind="pointcloud", channels=tuple(names), data=cloud, R=R, t=cam))
            assert svc.spin_once(now=0.1 * k) == 1
    _launched(before, 5, 0, 1, 1, 1, times=3)
    layers = torch_scenes.LAYERS + list(cfg.semantic_layers)
    gpu, cpu = (svc.mapper.get_layers(layers) for svc in services)
    torch_scenes.compare_layers("sensor into semantic service", gpu, cpu, packed=("rgb",))
    footprint = torch_scenes.IMAGE_SHAPE[0] * torch_scenes.IMAGE_SHAPE[1] * (1.5 / K[0, 0] / cfg.resolution) ** 2
    assert min(np.count_nonzero(np.nan_to_num(gpu[c])) for c in channels) >= 0.5 * footprint


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


# ---------------------------------------------------------------------------
# the shipped examples
# ---------------------------------------------------------------------------

# per example, K1's launches of its run as it ships (every example resolves
# to the polar cleanup, so K2 never runs) and D1's, D2's and D3's (one per
# update or batched step, per process for the sharded world; none per plane
# decomposition), D4's and D5's (the same, but none in the sharded world's
# processes); and regular expressions its main's output must match
EXAMPLES = {
    "plane_decomposition_demo": (2 * 6, 0, [r"^regions: ([2-9]|\d\d+)$", r"convex 12-gon"]),
    "minimal_mapping": (3 * 6 + 2, 6, [r"^elevation\s+valid=\s*\d+ range=\[[-+]\d",
                                       r"^polygon safety: is_safe=(True|False) trav=\d",
                                       r"^plane decomposition: \d+ planar regions$"]),
    "semantic_mapping": (5, 1, [r"green-dominant world: True", r"^layer rgb\s+finite cells: \d+$"]),
    "batched_datagen": (3 * 5, 5, [r"^devices=1  envs=32  cells=77\^2  pts/env=20000$",
                                   r"^steady-state: [0-9.]+ maps/s$"]),
    "robot_stack": (4 * 10 + 2, 10, [r"sensors=\['color_cam', 'front_lidar'\]", r"dropped: 0",
                                     r"^planar regions: [23]$", r"check_safety\[platform edge\]: safe=False"]),
    "large_world_sharded": (3 * 12, 12, [r"512x512 cells .* over 8 shards", r"building A top: 1\.2",
                                         r"^sharded world map ok$"]),
}


def _to_cpu(x):
    """Draws (tensors, lists, named tuples of tensors) copied to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_cpu(v) for v in x))
    return type(x)(_to_cpu(v) for v in x)


def _same_terrain(got, want, layers: bool = False) -> None:
    """Two decompositions of the same map on the card and the CPU: the same
    regions (labels on 99.9 % of cells; with ``layers``, every label, each
    plane's normal and support within 1e-5 and the terrain's layers within
    1e-5 on 99.9 % of cells)."""
    assert len(got.regions) == len(want.regions)
    assert float((got.labels == want.labels).mean()) >= (1.0 if layers else 0.999)
    if layers:
        for rg, rw in zip(got.regions, want.regions):
            assert rg.label == rw.label and np.abs(rg.normal - rw.normal).max() <= 1e-5
            assert np.abs(rg.support - rw.support).max() <= 1e-5
        for name in ("filtered_map", "elevation", "smooth_planar"):
            a, b = getattr(got, name), getattr(want, name)
            assert ((np.isnan(a) & np.isnan(b)) | (np.abs(a - b) <= 1e-5)).mean() >= 0.999, name


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_on_card_matches_cpu(card, tmp_path, name):
    """Each shipped example as a user runs it, on the card at the sizes it
    ships with: its kernel launches (per process for the sharded world of 8
    processes over gloo on one card), the lines its main prints, and its
    result against the same run on the CPU (1e-4 on 99.9 % of cells, packed
    colours bit for bit, the same draws for minimal mapping and batched
    datagen; the sharded world's gathered map against the unsharded card
    update within 1e-5)."""
    import contextlib
    import importlib
    import io
    import json
    import re
    import sys

    mod = importlib.import_module(f"elevation_mapping_cupy_torch.examples.{name}")
    k1, d12, patterns = EXAMPLES[name]
    before = _counts()
    if name == "plane_decomposition_demo":
        got = mod.run("cuda", out=str(tmp_path / "card.png"))
    elif name == "robot_stack":
        got = mod.run("cuda", mod.settings())
    elif name == "large_world_sharded":
        spy = [sys.executable, "-m", "tests.torch_scenes", "--example-world-worker", str(tmp_path)]
        got = mod.run("cuda", world=8, worker_argv=spy)
    else:
        got = mod.run("cuda")
    if name != "large_world_sharded":
        _launched(before, k1, 0, d12, d12, d12)
    run = mod.run
    mod.run = lambda *a, **k: got
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            mod.main(["--device", "cuda"])
    finally:
        mod.run = run
    for pat in patterns:
        assert re.search(pat, printed.getvalue(), re.M), (pat, printed.getvalue())
    cmp = torch_scenes.compare_layers
    if name == "plane_decomposition_demo":
        _same_terrain(got["terrain"], mod.run("cpu", out=str(tmp_path / "cpu.png"), repeats=0)["terrain"], layers=True)
    elif name == "minimal_mapping":
        want = mod.run("cpu", draws=_to_cpu(mod.make_draws("cuda")))
        assert bool(got["polygon"][0]) == bool(want["polygon"][0]) and abs(got["polygon"][1] - want["polygon"][1]) <= 1e-4
        cmp(name, got["layers"], want["layers"])
        _same_terrain(got["planes"], want["planes"])
    elif name == "semantic_mapping":
        cmp(name, got["layers"], mod.run("cpu")["layers"], packed=("rgb",))
    elif name == "batched_datagen":
        from elevation_mapping_cupy_torch.runtime import datagen

        gen = datagen.make_generator(0, "cuda")
        draws = [_to_cpu(datagen.draw_batch_clouds(gen, 32, got["cfg"].cell_n, 20_000)) for _ in range(5)]
        a, b = got["states"].layers.cpu().numpy(), mod.run("cpu", draws=draws)["states"].layers.numpy()
        torch_scenes.share_within(name, {i: a[:, i] for i in range(4)}, {i: b[:, i] for i in range(4)},
                                   torch_scenes.CMP_ATOL, torch_scenes.CMP_MIN_SHARE)
    elif name == "robot_stack":
        want = mod.run("cpu", mod.settings())
        assert got["safety"].keys() == want["safety"].keys()
        for key, (safe, trav, *_) in got["safety"].items():
            assert safe == want["safety"][key][0] and abs(trav - want["safety"][key][1]) <= 1e-4, key
        assert abs(got["drift"] - want["drift"]) <= 1e-4 and sorted(got["published"]) == sorted(want["published"])
        for key in ("layers", "published"):
            cmp(f"{name} {key}", got[key], want[key], packed=("rgb",))
        cmp(f"{name} submap", {"e": got["submap"]}, {"e": want["submap"]})
        _same_terrain(got["terrain"], want["terrain"])
    else:
        assert got["backend"] == "gloo"
        for rank in range(8):
            with open(tmp_path / f"rank{rank}.json") as f:
                rep = json.load(f)
            torch_scenes.check_launches(f"rank {rank}", rep["launches"], 1, {
                "scatter_add_streams": k1, "exact_march": 0, "dilation_fill": d12, "polar_evaluate": d12,
                "polar_scan": d12, "points_associate": 0, "points_fuse": 0})
        from elevation_mapping_cupy_torch.nn.traversability import default_weights
        from elevation_mapping_cupy_torch.state import init_state

        cfg, w = mod.CONFIG, default_weights().to(card)
        ref = init_state(cfg, card)
        mask = torch.ones(cfg.max_points, dtype=torch.bool, device=card)
        for pts in mod.clouds():
            ref = core.update_pointcloud(ref, torch.from_numpy(pts).to(card), mask, torch.eye(3, device=card),
                                         torch.from_numpy(mod.SENSOR_T).to(card), 0.0, 0.0, w, cfg)
        torch_scenes.share_within(name, {"layers": got["layers"], "normal": got["normal"]},
                                   {"layers": ref.layers.cpu().numpy(), "normal": ref.normal.cpu().numpy()},
                                   torch_scenes.SPATIAL_TOL, torch_scenes.CMP_MIN_SHARE)
