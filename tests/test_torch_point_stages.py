"""D4 (the point association) and D5 (the fusion's proposals): the plain
versions against the eager stages they stand for, the dispatch and the
kernels' argument checks on the CPU; the kernels against the plain versions
bit for bit on the card.

The card tests are marked ``cuda`` and skip without one; like
``tests/test_torch_cuda.py`` this file imports no JAX, so on the card it
runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_point_stages.py -q

The plain versions compose ``geometry.associate_points`` and the helpers of
``ops/pointcloud.py``, which ``tests/test_torch_ops.py`` holds to the JAX
package.
"""

import os
import re

import pytest
import torch

from elevation_mapping_cupy_torch import MapConfig, core, kernels
from elevation_mapping_cupy_torch.ops import point_stages as ps
from elevation_mapping_cupy_torch.ops import pointcloud as pc
from elevation_mapping_cupy_torch.ops import scatter
from elevation_mapping_cupy_torch.ops.geometry import associate_points
from tests import torch_scenes

CFG = MapConfig(resolution=0.1, map_length=3.0, max_ray_length=1.5, max_points=2000)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(b=2, n=1500, channels=0, seed=0, cfg=CFG):
    return torch_scenes.point_stage_inputs(cfg, b, n, "cpu", channels, seed, nan=False)


# the stages as core.update_batch_aux ran them before they were D4 and D5
def _inline_error_counting(layers, assoc, cfg, cell_rows):
    h, w = layers.shape[-2:]
    map_h, map_v, map_valid, map_t = (cell_rows[..., k] for k in range(4))
    z = assoc.world[..., 2]
    inlier = (
        assoc.mask
        & (map_valid > 0.5)
        & (torch.abs(map_h - z) < map_v * cfg.mahalanobis_thresh)
        & (map_v < cfg.drift_compensation_variance_inlier / 2.0)
        & (map_t > cfg.traversability_inlier)
    )
    sums = scatter.scatter_add_streams_2d(h, w, assoc.flat_idx, [inlier.to(layers.dtype), assoc.mask.to(layers.dtype)],
                                          assoc.mask)
    error_sum = torch.sum(torch.where(inlier, z - map_h, 0.0), dim=-1)
    return pc.ErrorCounts(sums[..., 0, :, :], sums[..., 1, :, :], error_sum, torch.sum(inlier, dim=-1)), inlier


def _inline_point_fusion(layers, assoc, point_cnt, cfg, cell_rows, h_delta):
    h, w = layers.shape[-2:]
    flat = layers.flatten(-2)
    j = assoc.flat_idx
    z = assoc.world[..., 2]
    v = assoc.noise
    map_h = cell_rows[..., 0] + h_delta[..., None]
    map_v = cell_rows[..., 1]
    pcnt = torch.gather(point_cnt.flatten(-2), -1, j.long())
    outlier = assoc.mask & (torch.abs(map_h - z) > map_v * cfg.mahalanobis_thresh)
    edge_skip = torch.zeros_like(outlier)
    if cfg.enable_edge_sharpen:
        edge_skip = (pcnt > cfg.wall_num_thresh) & (
            z < map_h - map_v * cfg.mahalanobis_thresh / torch.clamp(pcnt, min=1e-12))
    fuse = assoc.mask & ~outlier & ~edge_skip
    new_h = (map_h * v + z * map_v) / (map_v + v)
    new_v = (map_v * v) / (map_v + v)
    streams = [torch.where(fuse, new_h, 0.0), torch.where(fuse, new_v, 0.0), fuse.to(new_h.dtype),
               outlier.to(new_h.dtype)]
    sums = scatter.scatter_add_multi(h * w, j, streams, fuse | outlier)
    out_var = sums[..., 3, :] * cfg.outlier_variance
    sum_h, cnt = sums[..., 0, :], sums[..., 2, :]
    has = cnt > 0
    mean_h = sum_h / torch.clamp(cnt, min=1.0)
    flat = flat.clone()
    flat[..., 1, :] += out_var
    flat[..., 2, :] = torch.where(has, 1.0, flat[..., 2, :])
    flat[..., 4, :] = torch.where(has, 0.0, flat[..., 4, :])
    flat[..., 5, :] = torch.where(has, mean_h, flat[..., 5, :])
    flat[..., 6, :] = torch.where(has, 0.0, flat[..., 6, :])
    return flat.reshape(layers.shape), sums[..., :3, :].reshape(*sums.shape[:-2], 3, h, w), torch.stack(streams, -2)


# ---------------------------------------------------------------------------
# the plain versions on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,channels", [(1, 0), (3, 0), (2, 3)])
def test_plain_association_equals_the_eager_stages(b, channels):
    """On the CPU ``associate`` is associate_points, the row gather and the
    error counting's per-point half as the update ran them: every field bit
    for bit, K1's streams those of the inline inlier test, the error sums
    and counts those of error_counting."""
    points, pad, R, t, layers = _inputs(b, channels=channels, seed=b)
    got = ps.associate(points, pad, R, t, layers, CFG)
    assoc = associate_points(points[..., :3], pad, R, t, CFG)
    for name in assoc._fields:
        assert torch.equal(getattr(got.assoc, name), getattr(assoc, name)), name
    rows = pc.gather_cell_rows(layers, assoc.flat_idx)
    assert torch.equal(got.rows, rows[..., :2])
    counts, inlier = _inline_error_counting(layers, assoc, CFG, rows)
    assert torch.equal(got.counted, torch.stack([inlier.float(), assoc.mask.float()], dim=-2))
    assert torch.equal(got.error_sum, counts.error_sum) and torch.equal(got.error_cnt, counts.error_cnt)
    assert got.error_cnt.dtype == torch.int64 and int(got.error_cnt.sum()) > 0
    assert torch.equal(pc.error_counting(layers, assoc, CFG, rows).inlier_cnt, counts.inlier_cnt)


@pytest.mark.parametrize("edge_sharpen", [True, False])
@pytest.mark.parametrize("drifted", [False, True])
def test_plain_fusion_equals_point_fusion(edge_sharpen, drifted):
    """On the CPU ``fuse`` and ``fusion_apply`` give the inline fusion's
    streams, layers and sums bit for bit, with and without a drift
    correction and edge sharpening; ``point_fusion`` too."""
    cfg = CFG.replace(enable_edge_sharpen=edge_sharpen, wall_num_thresh=3.0)
    points, pad, R, t, layers = _inputs(3, seed=7)
    stage = ps.associate(points, pad, R, t, layers, cfg)
    rows = pc.gather_cell_rows(layers, stage.assoc.flat_idx)
    counts, _ = _inline_error_counting(layers, stage.assoc, cfg, rows)
    h_delta = torch.tensor([0.03, -0.02, 0.0]) if drifted else torch.zeros(3)
    want_layers, want_newmap, want_streams = _inline_point_fusion(layers, stage.assoc, counts.point_cnt, cfg, rows,
                                                                  h_delta)
    streams, active = ps.fuse(stage, h_delta, counts.point_cnt, cfg)
    assert torch.equal(streams, want_streams)
    assert torch.equal(active, (want_streams[:, 2] > 0) | (want_streams[:, 3] > 0))
    assert float(want_streams[:, 3].sum()) > 0 and float(want_streams[:, 2].sum()) > 0
    h, w = layers.shape[-2:]
    got_layers, got_newmap = pc.fusion_apply(layers, scatter.scatter_add_multi(h * w, stage.assoc.flat_idx, streams,
                                                                               active), cfg)
    assert torch.equal(got_layers, want_layers) and torch.equal(got_newmap, want_newmap)
    pf_layers, pf_newmap = pc.point_fusion(layers, stage.assoc, counts.point_cnt, cfg, rows, h_delta)
    assert torch.equal(pf_layers, want_layers) and torch.equal(pf_newmap, want_newmap)


def test_scatter_takes_stacked_streams():
    """K1's router takes the streams stacked (..., K, N) as it takes them
    one by one."""
    g = torch.Generator().manual_seed(3)
    idx = torch.randint(0, 50, (2, 300), generator=g, dtype=torch.int32)
    mask = torch.rand((2, 300), generator=g) < 0.8
    vals = torch.rand((2, 3, 300), generator=g)
    assert torch.equal(scatter.scatter_add_multi(50, idx, vals, mask),
                       scatter.scatter_add_multi(50, idx, list(vals.unbind(-2)), mask))
    assert torch.equal(scatter.scatter_add_streams_2d(5, 10, idx, vals, mask),
                       scatter.scatter_add_streams_2d(5, 10, idx, list(vals.unbind(-2)), mask))


def test_cpu_update_runs_each_plain_version_once_and_launches_nothing(monkeypatch):
    """A CPU update of whole maps runs the plain association and fusion once
    each, and counts no launch of either kernel."""
    calls = []
    for name in ("_associate", "_fuse"):
        real = getattr(ps, name)
        monkeypatch.setattr(ps, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    monkeypatch.setattr(ps, "launch_associate", None)  # never reached on the CPU
    monkeypatch.setattr(ps, "launch_fuse", None)
    from elevation_mapping_cupy_torch.nn.traversability import default_weights
    from elevation_mapping_cupy_torch.parallel import batched_update, init_batch

    points, pad, R, t, _ = _inputs(2)
    before = (ps.ASSOCIATE_KERNEL.launches, ps.FUSE_KERNEL.launches)
    z = torch.zeros(2)
    batched_update(init_batch(CFG, 2, "cpu"), points, pad, R, t, z, z, default_weights(), CFG)
    assert calls == ["_associate", "_fuse"]
    assert (ps.ASSOCIATE_KERNEL.launches, ps.FUSE_KERNEL.launches) == before


def test_cpu_chain_equals_the_eager_chain():
    """The update's per-point stages on the CPU (``core._fuse_points``) give
    the association, inlier counts, layers, sums and drift state of the
    inline stages bit for bit, with the drift gate open."""
    cfg = CFG.replace(min_height_drift_cnt=0.0, max_drift=1.0)
    from elevation_mapping_cupy_torch.state import init_batch

    points, pad, R, t, layers = _inputs(3, seed=11)
    state = init_batch(cfg, 3, "cpu")._replace(layers=layers)
    pn, on = torch.full((3,), 0.5), torch.zeros(3)
    got = core._fuse_points(state, points, pad, R, t, pn, on, cfg, False)
    assoc = associate_points(points[..., :3], pad, R, t, cfg)
    rows = pc.gather_cell_rows(layers, assoc.flat_idx)
    counts, _ = _inline_error_counting(layers, assoc, cfg, rows)
    drifted, mean_error, additive, h_delta = pc.apply_drift_compensation(
        layers, counts, pn, on, state.mean_error, state.additive_mean_error, cfg)
    assert bool((h_delta != 0).any())
    want_layers, want_newmap, _ = _inline_point_fusion(drifted, assoc, counts.point_cnt, cfg, rows, h_delta)
    for name in assoc._fields:
        assert torch.equal(getattr(got.assoc, name), getattr(assoc, name)), name
    assert torch.equal(got.inlier_cnt, counts.inlier_cnt)
    assert torch.equal(got.layers, want_layers) and torch.equal(got.newmap, want_newmap)
    assert torch.equal(got.mean_error, mean_error) and torch.equal(got.additive, additive)


# ---------------------------------------------------------------------------
# dispatch and argument checks, on the CPU
# ---------------------------------------------------------------------------

def _bad_associate(kind):
    args = list(_inputs(2, n=300))
    if kind == "float64_points":
        args[0] = args[0].double()
    elif kind == "int_pad":
        args[1] = args[1].to(torch.uint8)
    elif kind == "strided_R":
        args[2] = args[2].transpose(-1, -2)
    elif kind == "strided_xyz":
        args[0] = args[0].transpose(-1, -2).contiguous().transpose(-1, -2)
    elif kind == "points_shape":
        args[0] = args[0][..., :2]
    elif kind == "pad_shape":
        args[1] = args[1][:, 1:]
    elif kind == "t_shape":
        args[3] = args[3][:1]
    elif kind == "layers_shape":
        args[4] = args[4][:, :, 1:]
    elif kind != "cpu_tensors":
        raise AssertionError(kind)
    error = TypeError if kind in ("float64_points", "int_pad") else ValueError
    return args, error


ASSOC_SHAPES = ["points_shape", "pad_shape", "t_shape", "layers_shape"]


@pytest.mark.parametrize("kind", ["float64_points", "int_pad", "strided_R", "strided_xyz"] + ASSOC_SHAPES
                         + ["cpu_tensors"])
def test_association_kernel_refuses_before_any_build(monkeypatch, kind):
    """The association kernel's launch refuses what it does not take, CPU
    tensors last of all, without building the kernel or counting a
    launch."""
    def no_build():
        raise AssertionError("the kernel was built")

    monkeypatch.setattr(ps.ASSOCIATE_KERNEL, "load", no_build)
    args, error = _bad_associate(kind)
    before = ps.ASSOCIATE_KERNEL.launches
    with pytest.raises(error):
        ps.launch_associate(*args, CFG)
    assert ps.ASSOCIATE_KERNEL.launches == before


@pytest.mark.parametrize("kind", ASSOC_SHAPES)
def test_plain_association_refuses_the_same_shapes(kind):
    args, error = _bad_associate(kind)
    with pytest.raises(error):
        ps.associate(*args, CFG)


def _fuse_args():
    points, pad, R, t, layers = _inputs(2, n=300)
    stage = ps.associate(points, pad, R, t, layers, CFG)
    n = CFG.cell_n
    return stage, torch.tensor([0.01, 0.0]), (torch.rand((2, 2, n, n)) * 5)[:, 1]


@pytest.mark.parametrize("kind", ["float64_delta", "strided_rows", "strided_counts", "delta_shape", "counts_shape",
                                  "cpu_tensors"])
def test_fusion_kernel_refuses_before_any_build(monkeypatch, kind):
    def no_build():
        raise AssertionError("the kernel was built")

    monkeypatch.setattr(ps.FUSE_KERNEL, "load", no_build)
    stage, h_delta, point_cnt = _fuse_args()
    error = ValueError
    if kind == "float64_delta":
        h_delta, error = h_delta.double(), TypeError
    elif kind == "strided_rows":
        stage = stage._replace(rows=stage.rows.transpose(0, 1).contiguous().transpose(0, 1))
    elif kind == "strided_counts":
        point_cnt = point_cnt.transpose(-1, -2)
    elif kind == "delta_shape":
        h_delta = h_delta[:1]
    elif kind == "counts_shape":
        point_cnt = point_cnt[:, 1:]
    before = ps.FUSE_KERNEL.launches
    with pytest.raises(error):
        ps.launch_fuse(stage, h_delta, point_cnt, CFG)
    assert ps.FUSE_KERNEL.launches == before


def test_other_devices_are_refused():
    args = [x.to("meta") for x in _inputs(2, n=300)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ps.associate(*args, CFG)
    stage, h_delta, point_cnt = _fuse_args()
    with pytest.raises(ValueError, match="cuda or cpu"):
        ps.fuse(stage, h_delta, point_cnt.to("meta"), CFG)


def test_kernels_are_registered():
    regs = kernels.registered_kernels()
    assert regs["points_associate"] is ps.ASSOCIATE_KERNEL and regs["points_fuse"] is ps.FUSE_KERNEL
    assert ps.ASSOCIATE_KERNEL.source == ps.FUSE_KERNEL.source == "point_stages.cu"


def test_kernel_constants_match_the_source():
    """The constants the wrappers pass are those the kernels' ``Const``
    enumerates, one float32 each, in the same order as its comments."""
    with open(os.path.join(kernels.CSRC_DIR, "point_stages.cu")) as f:
        src = f.read()
    body = re.search(r"enum Const : int \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"^\s*(k\w+),", body, re.M)
    consts = ps._kernel_constants(CFG)
    assert names[-1] == "kMinCount" and len(names) == len(consts)
    assert consts[names.index("kRes")] == CFG.resolution
    assert consts[names.index("kTop")] == CFG.cell_n - 1
    assert consts[names.index("kMinDist2")] == CFG.min_valid_distance**2
    assert consts[names.index("kDriftVar")] == CFG.drift_compensation_variance_inlier / 2.0
    assert consts[names.index("kWall")] == CFG.wall_num_thresh


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

CARD_CASES = {
    "robot B=1": (torch_scenes.deployed_config(), 1, torch_scenes.MAIN_POINTS, 0),
    "B=8 N=100003": (MapConfig(), 8, 100003, 0),
    "B=64": (MapConfig(), 64, 100000, 0),
    "semantic C=3": (MapConfig(enable_edge_sharpen=False), 8, 20000, 3),
    "N=1000": (CFG, 3, 1000, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernels_match_plain_versions_on_card(card, case):
    """D4's fields and streams and D5's streams and mask equal the plain
    versions bit for bit (error_sum within 1e-6 and the same over two
    launches) on clouds with padding, NaN points, points beyond the map,
    on its border ring and on cell edges, with the drift gate open: B = 1,
    8 and 64, N not a multiple of 256, a semantic cloud of row stride 6."""
    cfg, b, n, channels = CARD_CASES[case]
    res = torch_scenes.check_point_stages(case, cfg, torch_scenes.point_stage_inputs(cfg, b, n, card, channels, b))
    assert res["inliers"] > 0 and res["outliers"] > 0 and res["fused"] > 0 and res["maps_drifted"] > 0


@pytest.mark.cuda
def test_kernels_on_empty_clouds(card):
    """A cloud of no points writes zero error sums and launches each kernel
    once; a batch of no maps launches nothing."""
    points, pad, R, t, layers = torch_scenes.point_stage_inputs(CFG, 2, 0, card)
    got = ps.associate(points, pad, R, t, layers, CFG)
    assert got.error_sum.tolist() == [0.0, 0.0] and got.error_cnt.tolist() == [0, 0]
    streams, active = ps.fuse(got, torch.zeros(2, device=card), layers[:, 0], CFG)
    assert streams.shape == (2, 4, 0) and active.shape == (2, 0)
    before = ps.ASSOCIATE_KERNEL.launches
    none = ps.associate(points[:0], pad[:0], R[:0], t[:0], layers[:0], CFG)
    assert none.error_sum.shape == (0,) and ps.ASSOCIATE_KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["polar", "exact"])
def test_step_equals_the_eager_chain_on_card(card, monkeypatch, mode):
    """A batched step of 8 datagen maps with D4 and D5 (one launch each)
    hands every K1 launch the same indices, masks and streams, bit for bit,
    as the same step through the plain versions on the card, and the two
    steps' states agree within 1e-4 on 99.9 % of cells (K1 adds its value
    streams with atomics, in an order that changes from run to run)."""
    from elevation_mapping_cupy_torch.nn.traversability import default_weights
    from elevation_mapping_cupy_torch.ops import cuda_scatter
    from elevation_mapping_cupy_torch.parallel import batched_update, init_batch
    from elevation_mapping_cupy_torch.runtime import datagen
    from elevation_mapping_cupy_torch.state import state_to_numpy

    cfg = MapConfig(max_points=20000, raycast_mode=mode)
    b = 8
    w = default_weights().to(card)
    z = torch.zeros(b, device=card)
    R = torch.eye(3, device=card).expand(b, 3, 3).contiguous()
    mask = torch.ones((b, 20000), dtype=torch.bool, device=card)
    clouds = [datagen.make_batch_clouds(datagen.make_generator(k, card), b, cfg.cell_n, cfg.resolution, 20000)
              for k in range(2)]
    first = batched_update(init_batch(cfg, b, card), clouds[0][0], mask, R, clouds[0][1], z, z, w, cfg)
    launch = cuda_scatter.scatter_add_streams

    def step():
        seen = []

        def recording(idx, mask_, values, n_cells):
            seen.append(tuple(x.clone() for x in (idx, mask_, values)))
            return launch(idx, mask_, values, n_cells)

        monkeypatch.setattr(cuda_scatter, "scatter_add_streams", recording)
        out = batched_update(first, clouds[1][0], mask, R, clouds[1][1], z, z, w, cfg)
        torch.cuda.synchronize()
        return out, seen

    before = (ps.ASSOCIATE_KERNEL.launches, ps.FUSE_KERNEL.launches)
    got, got_k1 = step()
    assert (ps.ASSOCIATE_KERNEL.launches - before[0], ps.FUSE_KERNEL.launches - before[1]) == (1, 1)
    monkeypatch.setattr(ps, "associate", ps._associate)
    monkeypatch.setattr(ps, "fuse", ps._fuse)
    want, want_k1 = step()
    assert len(got_k1) == len(want_k1) == (3 if mode == "polar" else 2)
    for k, (g, w_) in enumerate(zip(got_k1, want_k1)):
        for name, x, y in zip(("idx", "mask", "values"), g, w_):
            assert torch_scenes.same_bits(x, y), (k, name)
    torch_scenes.share_within(f"{mode} step", state_to_numpy(got), state_to_numpy(want), torch_scenes.CMP_ATOL,
                              torch_scenes.CMP_MIN_SHARE)
