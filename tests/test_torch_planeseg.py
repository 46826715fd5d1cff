"""The port's plane segmentation (``elevation_mapping_cupy_torch/planeseg``)
against the JAX package's, test for test of ``tests/test_planeseg.py``, on
the same inputs made with numpy from a seed, on the CPU (K1's plain
version).

Tolerances: labels, ``plane_valid`` and ``needs_refine`` equal; per-cell
normals, plane supports and the eigen-solve within 1e-5 of JAX;
connected components bit for bit; filtered maps bit for bit without a
resample and within 1e-6 with one; pipeline layers and region boundaries
within 1e-6.

Plane normals and supports are also held within 1e-5 of a float64 fit of
the same cells, and plane normals within 3e-5 of JAX. The port sums the
per-label moments about each component's first cell; JAX sums world
coordinates, and its float32 covariance ``sxx/n - mean**2`` cancels: on
the ramp scenes its flat plane's normal is up to 2.7e-5 off the float64
fit (``update_batch``), the port's is exact there.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elevation_mapping_cupy_tpu import planeseg as J
from elevation_mapping_cupy_tpu.planeseg import extract as JE

from elevation_mapping_cupy_torch import planeseg as P
from elevation_mapping_cupy_torch.ops.gridmap_filters import fixed_point
from elevation_mapping_cupy_torch.planeseg import extract as E

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORMAL_TOL = 1e-5
PLANE_NORMAL_TOL_JAX = 3e-5
LAYER_TOL = 1e-6


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def two_plane_terrain(n=48):
    h = np.zeros((n, n), np.float32)
    h[:, n // 2 :] = 0.5
    return h


def ramp_terrain(n=32):
    """A ramp beside a raised flat plane (the RANSAC scene of the JAX test)."""
    h = np.zeros((n, n), np.float32)
    h[:, : n // 2] = np.linspace(0, 0.3, n // 2)[None, :]
    h[:, n // 2 :] = 0.8
    return h


def box_terrain(n=48, seed=1):
    """Noisy ground with a raised square platform in the middle."""
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 0.001, (n, n)).astype(np.float32)
    q = n * 3 // 10
    h[q : n - q, q : n - q] += 0.3
    return h


def _plane_fit64(labels, h, res, origin=(0.0, 0.0)):
    """label -> (normal, mean) of a float64 fit of its finite cells, the
    normal's z made positive."""
    rows, cols = np.indices(labels.shape)
    out = {}
    for lab in np.unique(labels[labels > 0]):
        m = (labels == lab) & np.isfinite(h)
        pts = np.stack([origin[0] - rows[m] * res, origin[1] - cols[m] * res, h[m]], 1).astype(np.float64)
        w, v = np.linalg.eigh(np.cov(pts.T, bias=True))
        out[lab] = (v[:, 0] * np.sign(v[2, 0]), pts.mean(0))
    return out


def _same_extraction(got, want, h, res=0.04):
    labels = got.labels.numpy()
    np.testing.assert_array_equal(labels, np.asarray(want.labels))
    valid = np.asarray(want.plane_valid)
    np.testing.assert_array_equal(got.plane_valid.numpy(), valid)
    np.testing.assert_array_equal(got.needs_refine.numpy(), np.asarray(want.needs_refine))
    used = valid | np.asarray(want.needs_refine)
    pn, ps = got.plane_normals.numpy(), got.plane_support.numpy()
    np.testing.assert_allclose(pn[used], np.asarray(want.plane_normals)[used], atol=PLANE_NORMAL_TOL_JAX)
    np.testing.assert_allclose(ps[used], np.asarray(want.plane_support)[used], atol=NORMAL_TOL)
    for lab, (normal, mean) in _plane_fit64(labels, h, res).items():
        np.testing.assert_allclose(pn[lab], normal, atol=NORMAL_TOL)
        np.testing.assert_allclose(ps[lab], mean, atol=NORMAL_TOL)
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(want.normals), atol=NORMAL_TOL)


def _same_terrain(got, want, exact_filtered=True):
    """A port PlanarTerrain against the JAX one."""
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.plane_classification, want.plane_classification)
    if exact_filtered:
        np.testing.assert_array_equal(got.filtered_map.view(np.uint32), want.filtered_map.view(np.uint32))
    else:
        np.testing.assert_allclose(got.filtered_map, want.filtered_map, atol=LAYER_TOL)
    np.testing.assert_allclose(got.elevation, want.elevation, atol=LAYER_TOL)
    np.testing.assert_allclose(got.smooth_planar, want.smooth_planar, atol=LAYER_TOL)
    assert got.resolution == want.resolution
    np.testing.assert_allclose(got.map_origin, want.map_origin, atol=1e-12)
    assert len(got.regions) == len(want.regions)
    for rg, rw in zip(got.regions, want.regions):
        assert rg.label == rw.label
        np.testing.assert_allclose(rg.normal, rw.normal, atol=PLANE_NORMAL_TOL_JAX)
        np.testing.assert_allclose(rg.support, rw.support, atol=NORMAL_TOL)
        np.testing.assert_allclose(rg.boundary_with_holes.boundary, rw.boundary_with_holes.boundary, atol=LAYER_TOL)
        assert len(rg.boundary_with_holes.holes) == len(rw.boundary_with_holes.holes)
        for hg, hw in zip(rg.boundary_with_holes.holes, rw.boundary_with_holes.holes):
            np.testing.assert_allclose(hg, hw, atol=LAYER_TOL)
        assert len(rg.insets) == len(rw.insets)
        for ig, iw in zip(rg.insets, rw.insets):
            np.testing.assert_allclose(ig, iw, atol=LAYER_TOL)


def test_eigh3_matches_numpy(rng):
    A = rng.normal(0, 1, (64, 3, 3))
    A = ((A + np.swapaxes(A, 1, 2)) / 2).astype(np.float32)
    lam_min, lam_mid, v = P.eigh3_smallest(_t(A))
    w = np.linalg.eigvalsh(A.astype(np.float64))
    np.testing.assert_allclose(lam_min.numpy(), w[:, 0], atol=2e-4)
    np.testing.assert_allclose(lam_mid.numpy(), w[:, 1], atol=2e-4)
    # eigenvector check: A v = lambda v
    Av = np.einsum("bij,bj->bi", A.astype(np.float64), v.numpy().astype(np.float64))
    lv = lam_min.numpy()[:, None].astype(np.float64) * v.numpy()
    np.testing.assert_allclose(Av, lv, atol=5e-3)
    # and the JAX solve, value for value (its cos and arccos round apart)
    for got, want in zip((lam_min, lam_mid, v), J.eigh3_smallest(jnp.asarray(A))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_connected_components_two_blobs():
    mask = np.zeros((16, 16), bool)
    mask[2:6, 2:6] = True
    mask[10:14, 10:14] = True
    labels = P.connected_components(_t(mask)).numpy()
    assert labels[3, 3] > 0 and labels[11, 11] > 0
    assert labels[3, 3] != labels[11, 11]
    assert (labels[~mask] == 0).all()
    assert len(np.unique(labels[2:6, 2:6])) == 1
    np.testing.assert_array_equal(labels, np.asarray(J.connected_components(jnp.asarray(mask))))


def _snaky_mask(rng, density, n=40):
    mask = rng.random((n, n)) < density
    # carve a spiral-ish long path to stress propagation depth
    mask[1, 1:-1] = True
    mask[1:-1, -2] = True
    mask[-2, 1:-1] = True
    return mask


@pytest.mark.parametrize("connectivity", [4, 8])
def test_connected_components_matches_scipy(rng, connectivity):
    """Random masks incl. snaky shapes: label partition must equal scipy's
    (pointer-jumping must not merge/split components), and the labels
    JAX's bit for bit."""
    from scipy import ndimage

    struct = (np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
              if connectivity == 4 else np.ones((3, 3)))
    for density in (0.35, 0.55, 0.75):
        mask = _snaky_mask(rng, density)
        ours = P.connected_components(_t(mask), connectivity).numpy()
        np.testing.assert_array_equal(ours, np.asarray(J.connected_components(jnp.asarray(mask), connectivity)))
        ref, n_ref = ndimage.label(mask, structure=struct)
        assert (ours[~mask] == 0).all()
        assert len(np.unique(ours[mask])) == n_ref
        # same partition: our label must be constant on each scipy component
        # and distinct across components
        mapping = {}
        for lab in np.unique(ref[mask]):
            vals = np.unique(ours[ref == lab])
            assert len(vals) == 1, f"component {lab} split"
            assert vals[0] not in mapping.values(), f"component {lab} merged"
            mapping[lab] = vals[0]


@pytest.mark.parametrize("max_iters", [1, 2, 3])
@pytest.mark.parametrize("connectivity", [4, 8])
def test_connected_components_round_cap(connectivity, max_iters, monkeypatch):
    """The round cap as JAX counts it: one round, then at most max_iters
    more. A long snake is not labelled in so few rounds, so the capped
    labels (unlike the fixed point) pin the count."""
    mask = np.zeros((24, 24), bool)
    for r in range(1, 23, 4):
        mask[r, 1:23] = True
        mask[r : r + 4, 22 if (r // 4) % 2 == 0 else 1] = True
    mask[23] = False
    want = np.asarray(J.connected_components(jnp.asarray(mask), connectivity, max_iters))
    got = P.connected_components(_t(mask), connectivity, max_iters)
    np.testing.assert_array_equal(got.numpy(), want)
    fixed = P.connected_components(_t(mask), connectivity).numpy()
    assert not np.array_equal(want, fixed), "the cap must cut the propagation short"
    rounds = []

    def recording(step, x, cap):
        out = fixed_point(step, x, cap)
        rounds.append(out[1])
        return out

    monkeypatch.setattr(E, "fixed_point", recording)
    P.connected_components(_t(mask), connectivity, max_iters)
    assert rounds == [max_iters]  # after the one round before the loop


def test_extract_planes_two_levels():
    h = two_plane_terrain()
    params = P.PlaneSegParams()
    ext = P.extract_planes(_t(h), 0.04, params)
    labels = ext.labels.numpy()
    valid = ext.plane_valid.numpy()
    present = [l for l in np.unique(labels) if l != 0 and valid[l]]
    assert len(present) == 2
    normals = ext.plane_normals.numpy()
    for l in present:
        assert normals[l][2] > 0.99  # flat planes → +Z normals
    # the step edge itself should not be planar
    edge_col = h.shape[1] // 2
    assert (labels[:, edge_col - 1 : edge_col + 1] == 0).any()
    for scene in (h, box_terrain(), ramp_terrain()):
        _same_extraction(P.extract_planes(_t(scene), 0.04, params), J.extract_planes(jnp.asarray(scene), 0.04, params), scene)


def test_pipeline_end_to_end():
    h = two_plane_terrain()
    h[5, 5] = np.nan  # hole → preprocess inpaints
    pipe = P.PlaneDecompositionPipeline(resolution=0.04, device="cpu")
    terrain = pipe.update(h)
    assert len(terrain.regions) == 2
    assert np.isfinite(terrain.filtered_map).all()
    assert terrain.smooth_planar.shape == h.shape
    assert "total" in terrain.timings
    report = pipe.timing_report()
    assert "sliding_window" in report
    want = J.PlaneDecompositionPipeline(resolution=0.04)
    _same_terrain(terrain, want.update(h))
    assert list(pipe._stats) == list(want._stats)


def test_pipeline_default_device_is_cuda():
    """No device means CUDA; without a card that raises and names the way
    out. Nothing falls back to the CPU unasked."""
    if torch.cuda.is_available():
        assert P.PlaneDecompositionPipeline(0.04).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.PlaneDecompositionPipeline(0.04)
    assert P.PlaneDecompositionPipeline(0.04, device="cpu").device.type == "cpu"


def test_convex_region_growing():
    boundary = np.array([[0, 0], [10.0, 0], [10, 10], [0, 10]])
    hole = np.array([[4, 4], [6.0, 4], [6, 6], [4, 6]])
    poly = P.grow_convex_polygon(boundary, [hole], np.array([2.0, 2.0]), n_vertices=12)
    assert poly is not None
    # grown polygon stays inside the boundary and outside the hole
    assert (poly >= -1e-6).all() and (poly <= 10 + 1e-6).all()
    for p in poly:
        assert not (4 < p[0] < 6 and 4 < p[1] < 6)
    np.testing.assert_array_equal(poly, J.grow_convex_polygon(boundary, [hole], np.array([2.0, 2.0]), n_vertices=12))


def test_pipeline_ransac_path():
    # a ramp beside a raised plane; the RANSAC refinement is on
    h = ramp_terrain()
    params = P.PlaneSegParams(include_ransac_refinement=True)
    pipe = P.PlaneDecompositionPipeline(resolution=0.04, params=params, device="cpu")
    terrain = pipe.update(h)
    assert len(terrain.regions) >= 2
    _same_terrain(terrain, J.PlaneDecompositionPipeline(resolution=0.04, params=params).update(h))


def test_pipeline_ransac_refines_a_bent_plane():
    """A label that fails the global planarity gate goes through the host
    RANSAC refinement, as in JAX: a gentle fold (each window planar, the
    whole not) beside a flat plane."""
    n = 32
    h = np.zeros((n, n), np.float32)
    fold = np.abs(np.arange(n // 2) - n // 4) * 0.012
    h[:, : n // 2] = fold[None, :]
    h[:, n // 2 :] = 0.5
    params = P.PlaneSegParams(include_ransac_refinement=True)
    ext = P.extract_planes(_t(P.preprocess(_t(h))), 0.04, params)
    assert ext.needs_refine.numpy().any()
    got = P.PlaneDecompositionPipeline(resolution=0.04, params=params, device="cpu").update(h)
    _same_terrain(got, J.PlaneDecompositionPipeline(resolution=0.04, params=params).update(h))


def test_convex_approximation_prefers_region_over_hole():
    """A query above a raised platform sits inside the GROUND region's hole;
    convex_approximation must pick the platform region (hole-aware selection,
    SegmentedPlaneProjection.cpp:56-97) and grow a polygon there."""
    n = 48
    h = box_terrain(n)
    q = n * 3 // 10
    pipe = P.PlaneDecompositionPipeline(resolution=0.04, device="cpu")
    terrain = pipe.update(h)
    assert len(terrain.regions) == 2
    # world frame: x = -row*res, y = -col*res; center of the box
    query = np.array([-(n // 2) * 0.04, -(n // 2) * 0.04], np.float32)
    poly = pipe.convex_approximation(terrain, query, n_vertices=12)
    assert poly is not None
    # grown polygon stays within the platform footprint (+1 cell slack)
    lo, hi = -(n - q + 1) * 0.04, -(q - 1) * 0.04
    assert (poly >= lo).all() and (poly <= hi).all()
    jpipe = J.PlaneDecompositionPipeline(resolution=0.04)
    jterrain = jpipe.update(h)
    _same_terrain(terrain, jterrain)
    np.testing.assert_allclose(poly, jpipe.convex_approximation(jterrain, query, n_vertices=12), atol=LAYER_TOL)


def test_project_to_planar_region():
    from elevation_mapping_cupy_torch.planeseg.contour import (
        BoundaryWithHoles, PlanarRegion, project_to_planar_region,
    )
    region = PlanarRegion(
        label=1,
        normal=np.array([0.0, 0.0, 1.0]),
        support=np.array([0.0, 0.0, 0.3]),
        boundary_with_holes=BoundaryWithHoles(
            boundary=np.array([[0, 0], [2.0, 0], [2, 2], [0, 2]]), holes=[]
        ),
        insets=[],
    )
    hit = project_to_planar_region(np.array([1.0, 1.0]), [region])
    assert hit is not None
    _, p = hit
    np.testing.assert_allclose(p, [1.0, 1.0, 0.3], atol=1e-9)
    # outside → projected to the boundary
    _, p2 = project_to_planar_region(np.array([3.0, 1.0]), [region])
    assert p2[0] <= 2.0 + 1e-9


def test_map_io_and_faults(tmp_path, rng):
    from elevation_mapping_cupy_torch.utils.map_io import save_layer_as_image, load_heightmap_from_image
    from elevation_mapping_cupy_torch.runtime.faults import add_map_noise, corrupt_cloud, drop_frames
    from elevation_mapping_cupy_tpu.runtime import faults as jfaults
    from elevation_mapping_cupy_tpu.utils import map_io as jmap_io

    h = rng.uniform(0, 1, (16, 16)).astype(np.float32)
    path = str(tmp_path / "map.png")
    lo, hi = save_layer_as_image(h, path)
    h2 = load_heightmap_from_image(path, height_scale=hi - lo, offset=lo)
    np.testing.assert_allclose(h2, h, atol=(hi - lo) / 255 + 1e-6)
    jpath = str(tmp_path / "jax_map.png")
    assert jmap_io.save_layer_as_image(h, jpath) == (lo, hi)
    np.testing.assert_array_equal(h2, jmap_io.load_heightmap_from_image(jpath, height_scale=hi - lo, offset=lo))

    noisy = add_map_noise(h, 0.01)
    assert noisy.shape == h.shape and not np.allclose(noisy, h)
    np.testing.assert_array_equal(noisy, jfaults.add_map_noise(h, 0.01))
    cloud = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    bad = corrupt_cloud(cloud, nan_frac=0.1, outlier_frac=0.05)
    assert np.isnan(bad[:, 0]).sum() == 10
    np.testing.assert_array_equal(bad, jfaults.corrupt_cloud(cloud, nan_frac=0.1, outlier_frac=0.05))
    assert list(drop_frames(range(10))) == list(jfaults.drop_frames(range(10)))


def _batch_scenes():
    n = 32
    rng = np.random.default_rng(3)
    maps, origins = [], []
    h0 = two_plane_terrain(n)
    maps.append(h0)
    origins.append((0.0, 0.0))
    maps.append(ramp_terrain(n))
    origins.append((1.5, -0.75))
    h2 = rng.normal(0, 0.001, h0.shape).astype(np.float32)
    h2[8:20, 8:20] += 0.3
    h2[5, 5] = np.nan
    maps.append(h2)
    origins.append((0.0, 0.4))
    return np.stack(maps), np.asarray(origins, np.float32)


def test_update_batch_matches_sequential():
    """update_batch (one batched device stage for B maps) produces the same
    labels/regions/layers as per-map update(), including a map that takes
    the RANSAC refinement path and a non-zero world origin; and both equal
    the JAX package's batch."""
    maps, origins = _batch_scenes()
    params = P.PlaneSegParams(include_ransac_refinement=True)
    pipe = P.PlaneDecompositionPipeline(resolution=0.04, params=params, device="cpu")
    seq = [pipe.update(m, o) for m, o in zip(maps, origins)]
    batch = pipe.update_batch(maps, origins)

    assert len(batch) == len(seq)
    for s, b in zip(seq, batch):
        np.testing.assert_array_equal(b.labels, s.labels)
        np.testing.assert_allclose(b.filtered_map, s.filtered_map, atol=1e-6)
        np.testing.assert_allclose(b.elevation, s.elevation, atol=1e-6)
        np.testing.assert_allclose(b.smooth_planar, s.smooth_planar, atol=1e-6)
        np.testing.assert_array_equal(b.plane_classification, s.plane_classification)
        assert b.resolution == s.resolution
        assert np.allclose(b.map_origin, s.map_origin)
        assert len(b.regions) == len(s.regions)
        for rb, rs in zip(b.regions, s.regions):
            np.testing.assert_allclose(rb.normal, rs.normal, atol=1e-6)
            np.testing.assert_allclose(rb.support, rs.support, atol=1e-6)
            np.testing.assert_allclose(
                rb.boundary_with_holes.boundary,
                rs.boundary_with_holes.boundary, atol=1e-6,
            )
    jbatch = J.PlaneDecompositionPipeline(resolution=0.04, params=params).update_batch(maps, origins)
    for b, jb in zip(batch, jbatch):
        _same_terrain(b, jb)


def test_update_batch_with_resample():
    """Batch path honors the changeResolution stage (shared out_shape,
    per-map origins); so does JAX's, to within 1e-6."""
    h = two_plane_terrain()
    pre = E.PreprocessingParams(resolution=0.08)
    pipe = P.PlaneDecompositionPipeline(resolution=0.04, preprocessing=pre, device="cpu")
    seq = pipe.update(h, (0.5, 0.0))
    batch = pipe.update_batch(h[None], np.asarray([(0.5, 0.0)], np.float32))[0]
    assert batch.labels.shape == seq.labels.shape
    np.testing.assert_array_equal(batch.labels, seq.labels)
    np.testing.assert_allclose(batch.smooth_planar, seq.smooth_planar, atol=1e-6)
    assert np.allclose(batch.map_origin, seq.map_origin)
    jpipe = J.PlaneDecompositionPipeline(resolution=0.04, preprocessing=JE.PreprocessingParams(resolution=0.08))
    _same_terrain(seq, jpipe.update(h, (0.5, 0.0)), exact_filtered=False)
    _same_terrain(batch, jpipe.update_batch(h[None], np.asarray([(0.5, 0.0)], np.float32))[0], exact_filtered=False)


def _draw_regions():
    from elevation_mapping_cupy_torch.planeseg.contour import BoundaryWithHoles, PlanarRegion

    res = 0.1
    origin = (0.0, 0.0)

    def world(px_ring):
        px = np.asarray(px_ring, np.float64)
        return np.stack([origin[0] - px[:, 0] * res,
                         origin[1] - px[:, 1] * res], axis=1)

    reg = PlanarRegion(
        label=1,
        normal=np.array([0.0, 0.0, 1.0]),
        support=np.array([0.0, 0.0, 0.3]),
        boundary_with_holes=BoundaryWithHoles(
            boundary=world([(2, 2), (2, 10), (10, 10), (10, 2)]), holes=[world([(5, 5), (5, 7), (7, 7), (7, 5)])]),
        insets=[world([(4, 4), (4, 8), (8, 8), (8, 4)])],
    )
    reg2 = PlanarRegion(
        label=2, normal=np.array([0.0, 0.0, 1.0]),
        support=np.array([0.0, 0.0, 0.0]),
        boundary_with_holes=BoundaryWithHoles(
            boundary=world([(12, 12), (12, 14), (14, 14), (14, 12)]), holes=[]),
        insets=[],
    )
    return reg, reg2, res, origin


def test_draw_rendering_golden():
    """Draw.cpp / RosVisualizations parity: vertex→pixel placement, hole
    handling, per-region palette colors, marker structure (DELETEALL lead,
    closed rings, plane-projected z); the port's copy renders what the JAX
    package's does."""
    from elevation_mapping_cupy_torch.planeseg import draw
    from elevation_mapping_cupy_tpu.planeseg import draw as jdraw

    reg, reg2, res, origin = _draw_regions()
    elev = np.zeros((16, 16), np.float32)
    img = draw.render_boundaries(elev, [reg, reg2], res, origin)
    c0 = draw.region_color(0)
    c1 = draw.region_color(1)
    for r, c in [(2, 2), (2, 10), (10, 10), (10, 2)]:
        np.testing.assert_array_equal(img[r, c], c0)
    np.testing.assert_array_equal(img[2, 6], c0)      # edge midpoint
    for r, c in [(5, 5), (5, 7), (7, 7), (7, 5)]:     # holes share the color
        np.testing.assert_array_equal(img[r, c], c0)
    np.testing.assert_array_equal(img[12, 12], c1)    # 2nd region: next color
    np.testing.assert_array_equal(img[3, 3], [0, 0, 0])
    assert not np.array_equal(img[4, 6], c0)          # no insets drawn

    ins = draw.render_insets(elev, [reg], res, origin)
    for r, c in [(4, 4), (4, 8), (8, 8), (8, 4)]:
        np.testing.assert_array_equal(ins[r, c], c0)
    assert not np.array_equal(ins[2, 2], c0)

    mk = draw.boundary_markers([reg, reg2], line_width=0.01)
    assert mk[0]["type"] == "DELETEALL"
    assert [m["id"] for m in mk[1:]] == [1, 2, 3]
    b = mk[1]
    assert b["type"] == "LINE_STRIP" and b["scale_x"] == 0.01
    np.testing.assert_allclose(b["points"][0], b["points"][-1])
    np.testing.assert_allclose(b["points"][:, 2], 0.3)
    np.testing.assert_allclose(b["color"][:3], draw.REGION_COLORMAP[0], atol=1e-6)
    np.testing.assert_allclose(mk[3]["color"][:3], draw.REGION_COLORMAP[1], atol=1e-6)
    imk = draw.inset_markers([reg])
    assert imk[0]["type"] == "DELETEALL" and len(imk) == 2
    np.testing.assert_allclose(imk[1]["points"][:, 2], 0.3)
    img3 = draw.render_boundaries(elev, [reg], res, origin, scale=3.0)
    assert img3.shape == (48, 48, 3)
    np.testing.assert_array_equal(img3[6, 6], c0)

    np.testing.assert_array_equal(img, jdraw.render_boundaries(elev, [reg, reg2], res, origin))
    np.testing.assert_array_equal(ins, jdraw.render_insets(elev, [reg], res, origin))
    np.testing.assert_array_equal(img3, jdraw.render_boundaries(elev, [reg], res, origin, scale=3.0))
    for m, jm in zip(mk, jdraw.boundary_markers([reg, reg2], line_width=0.01)):
        assert m.keys() == jm.keys()
        for key in m:
            np.testing.assert_array_equal(np.asarray(m[key]), np.asarray(jm[key]))


def test_draw_overlay_roundtrip(tmp_path):
    """save_decomposition_overlay writes a loadable image of the right size,
    the same pixels as the JAX package's."""
    from elevation_mapping_cupy_torch.planeseg.contour import BoundaryWithHoles, PlanarRegion
    from elevation_mapping_cupy_torch.planeseg import draw
    from elevation_mapping_cupy_tpu.planeseg import draw as jdraw

    reg = PlanarRegion(
        label=1, normal=np.array([0, 0, 1.0]), support=np.zeros(3),
        boundary_with_holes=BoundaryWithHoles(
            boundary=np.array([[-0.2, -0.2], [-0.2, -1.0], [-1.0, -1.0]]),
            holes=[]),
        insets=[],
    )
    path = str(tmp_path / "overlay.png")
    img = draw.save_decomposition_overlay(path, np.zeros((16, 16), np.float32), [reg], 0.1)
    assert img.shape == (16, 16, 3)
    assert os.path.exists(path) or os.path.exists(path + ".npy")
    jimg = jdraw.save_decomposition_overlay(str(tmp_path / "jax.png"), np.zeros((16, 16), np.float32), [reg], 0.1)
    np.testing.assert_array_equal(img, jimg)


@pytest.mark.parametrize("path", [
    "planeseg/contour.py", "planeseg/ransac.py", "planeseg/draw.py", "utils/map_io.py", "runtime/faults.py",
])
def test_host_modules_are_copies(path):
    """The host modules are the JAX package's, byte for byte (they import
    NumPy, and cv2 only inside functions)."""
    with open(os.path.join(REPO, "elevation_mapping_cupy_torch", path), "rb") as f:
        ours = f.read()
    with open(os.path.join(REPO, "elevation_mapping_cupy_tpu", path), "rb") as f:
        assert ours == f.read()
