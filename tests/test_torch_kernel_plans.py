"""What the CPU can check of the port's two CUDA kernels' redesign.

K1's launch plan (which path a shape takes, and how many blocks with how
much shared memory), the Python mirror of K2's closed-form live-step count
against ``torch.searchsorted``, and the CPU contract of ``exact_march``.
The kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import math

import numpy as np
import pytest
import torch

from tests import torch_scenes
from elevation_mapping_cupy_torch import MapConfig
from elevation_mapping_cupy_torch.ops import cuda_march, cuda_scatter
from elevation_mapping_cupy_torch.ops.geometry import fma32, sqrt32

from .test_torch_cuda import SYNTHETIC_KW, synthetic_march_inputs


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# K1: the launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [torch_scenes.deployed_config(), MapConfig()], ids=["deployed", "default"])
def test_map_scatters_take_the_private_path_and_the_cube_the_global(cfg):
    cells = cfg.cell_n * cfg.cell_n
    assert cells == 40804
    for k in (2, 4):
        plan = cuda_scatter.launch_plan(1, k, 131072, cells)
        assert plan.path == "private" and plan.shared_bytes == 163216
        assert plan.threads == 1024 and plan.slices == cuda_scatter.SM_COUNT // k
    bins = cfg.azimuth_bins * (cfg.n_ray_steps + 2) * cfg.raycast_elevation_bins
    cube = cuda_scatter.launch_plan(1, 2, 131072, bins)
    assert cube == cuda_scatter.LaunchPlan("global", 0, 256, 0, 512)


def test_deployed_cube_has_23_million_bins():
    cfg = torch_scenes.deployed_config()
    assert cfg.azimuth_bins * (cfg.n_ray_steps + 2) * cfg.raycast_elevation_bins == 23_265_280


@pytest.mark.parametrize("n_cells, path", [(58112, "private"), (58113, "global"), (241 * 241, "private"),
                                           (242 * 242, "global"), (400 * 400, "global"), (1, "private")])
def test_path_turns_at_the_shared_memory_of_a_block(n_cells, path):
    plan = cuda_scatter.launch_plan(1, 2, 50000, n_cells)
    assert plan.path == path
    if path == "private":
        assert plan.shared_bytes == 4 * n_cells <= cuda_scatter.MAX_SHARED_BYTES == 232448
    else:
        assert plan.shared_bytes == 0 and plan.slices == 0 and 4 * n_cells > cuda_scatter.MAX_SHARED_BYTES


@pytest.mark.parametrize("b, k, n", [(1, 2, 131072), (1, 4, 1 << 20), (4, 7, 131072), (4, 7, 100), (1, 1, 1),
                                     (16, 16, 5000), (1, 3, 0), (2, 200, 4096)])
def test_private_plan_fills_no_more_blocks_than_it_says(b, k, n):
    plan = cuda_scatter.launch_plan(b, k, n, 202 * 202)
    assert plan.path == "private"
    assert plan.slices >= 1 and plan.blocks == plan.slices * k * b
    # one block a stream pair at least; beyond that never more than the card's SMs
    assert plan.blocks <= max(cuda_scatter.SM_COUNT, k * b)
    # no slice is cut below the points that pay for a block's tile
    assert plan.slices == 1 or n / plan.slices >= cuda_scatter.MIN_SLICE_POINTS / 2
    if n >= cuda_scatter.SM_COUNT * cuda_scatter.MIN_SLICE_POINTS and k * b <= cuda_scatter.SM_COUNT:
        assert plan.blocks > cuda_scatter.SM_COUNT - k * b   # a large cloud fills the card


def test_batched_wide_launch_is_one_plan():
    plan = cuda_scatter.launch_plan(4, 7, 131072, 202 * 202)
    assert plan == cuda_scatter.LaunchPlan("private", 4, 1024, 163216, 112)


# ---------------------------------------------------------------------------
# K2: the closed-form live-step count
# ---------------------------------------------------------------------------

def _ulp_neighbours(steps: torch.Tensor) -> torch.Tensor:
    inf = torch.tensor(math.inf)
    return torch.cat([torch.nextafter(steps, -inf), steps, torch.nextafter(steps, inf)])


@pytest.mark.parametrize("inclusive", [False, True], ids=["left", "right"])
@pytest.mark.parametrize("cfg", [torch_scenes.deployed_config(), MapConfig()], ids=["deployed-353", "default-70"])
def test_steps_below_equals_searchsorted(cfg, inclusive):
    """Every float32 one ulp below, at and one ulp above each s_m, zero,
    negatives, +inf and random x: the count equals searchsorted's."""
    n_steps = cfg.n_ray_steps
    assert n_steps == (353 if cfg.max_ray_length == 10.0 else 70)
    steps = cuda_march.ray_steps(cfg, "cpu")
    rng = np.random.default_rng(7)
    x = torch.cat([
        _ulp_neighbours(steps),
        torch.tensor([0.0, -0.0, -1.0, -1e30, 1e-30, math.inf, 1e30, float(steps[-1]) * 2]),
        torch.from_numpy(rng.uniform(-1.0, 1.2 * float(steps[-1]), 20000).astype(np.float32)),
        torch.from_numpy((rng.integers(0, n_steps + 3, 5000) * cfg.ray_step).astype(np.float32)),
    ])
    want = torch.searchsorted(steps, x.contiguous(), side="right" if inclusive else "left")
    got = cuda_march.steps_below(x, inclusive, cfg.ray_step, n_steps)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert int(got.min()) == 0 and int(got.max()) == n_steps


def test_steps_below_with_no_steps():
    x = torch.tensor([-1.0, 0.0, 3.0, math.inf])
    assert cuda_march.steps_below(x, True, 0.03, 0).tolist() == [0, 0, 0, 0]


def test_ray_table_counts_match_the_closed_form():
    """The plain version's live-step count (two searchsorted calls) equals
    the closed form on the rays of the smoke scene."""
    cfg = torch_scenes.deployed_config()
    rng = np.random.default_rng(3)
    R, t, _ = torch_scenes.robot_pose(2)
    world = torch.from_numpy((torch_scenes.scene_cloud(rng, 4096, R, t) @ R.T + t).astype(np.float32))
    t = torch.from_numpy(t)
    valid = torch.ones(4096, dtype=torch.bool)
    _, k = cuda_march.ray_table(world, valid, t, cfg)
    v = world - t  # the table's own norm, rounded as ray_table rounds it
    norm = sqrt32(fma32(v[:, 2], v[:, 2], fma32(v[:, 1], v[:, 1], v[:, 0] * v[:, 0])))
    length = torch.clamp(norm, max=cfg.max_ray_length)
    end = norm - torch.tensor(cuda_march._ROOT_01, dtype=torch.float32) + torch.tensor(cfg.ray_step, dtype=torch.float32)
    closed = torch.minimum(
        cuda_march.steps_below(length, False, cfg.ray_step, cfg.n_ray_steps),
        cuda_march.steps_below(end, True, cfg.ray_step, cfg.n_ray_steps),
    )
    assert torch.equal(closed.to(torch.int32), k)
    assert int(k.min()) < 20 and int(k.max()) > 150


# ---------------------------------------------------------------------------
# K2: the CPU contract of the wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("kind", ["parallel", "lengths"])
def test_exact_march_on_cpu_is_the_plain_version(kind, gated):
    """On CPU tensors the wrapper returns the plain version's result:
    contiguous (n*n,) float32 dec, hits and ubmin, no launch counted. The
    inputs are the card tests' synthetic rays, so this also shows that those
    cases hit cells, write upper bounds and (gated) cull segments."""
    cfg = MapConfig(**SYNTHETIC_KW, raycast_mode="exact")
    lanes = cuda_march.LANES_GATED if gated else cuda_march.LANES_FLAT
    pack, world, valid, t, gate = synthetic_march_inputs(cfg, kind, lanes, "cpu", gated)
    before = cuda_march.KERNEL.launches
    got = cuda_march.exact_march(pack, world, valid, t, cfg, gate)
    want = cuda_march.exact_march_reference(pack, world, valid, t, cfg, gate)
    assert cuda_march.KERNEL.launches == before
    n2 = cfg.cell_n**2
    for name in ("dec", "hits", "ubmin"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == (n2,) and a.dtype == torch.float32 and a.is_contiguous(), name
        assert torch.equal(a, b), name
    assert float(got.hits.sum()) > 0 and bool(torch.isfinite(got.ubmin).any())
    if gated:
        assert got.counts.dtype == torch.int64 and torch.equal(got.counts, want.counts)
        assert 0 < int(got.counts[0]) <= int(got.counts[1])
    else:
        assert got.counts is None
    if kind == "lengths":
        k = cuda_march.ray_table(world, valid, t, cfg)[1]
        for want_k in (0, 1, lanes - 1, lanes, lanes + 1, 2 * lanes + 1):
            assert bool((k == want_k).any()), f"no ray with {want_k} live steps"


def test_lane_counts_are_ones_the_kernel_builds():
    assert cuda_march.LANES_FLAT in (16, 32) and cuda_march.LANES_GATED in (16, 32)
