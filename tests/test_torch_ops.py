"""The PyTorch port's per-stage functions against their JAX counterparts.

Both packages get the same NumPy inputs (seeded) and a map state built by
the JAX package; each port function is held to its JAX function at the
tolerance stated beside it. Everything runs on the CPU at a small map size.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elevation_mapping_cupy_tpu import MapConfig as JaxConfig
from elevation_mapping_cupy_tpu import core as jcore
from elevation_mapping_cupy_tpu import init_state as jinit_state
from elevation_mapping_cupy_tpu.nn import traversability as jtrav
from elevation_mapping_cupy_tpu.ops import geometry as jgeo
from elevation_mapping_cupy_tpu.ops import pointcloud as jpc
from elevation_mapping_cupy_tpu.ops import raycast as jrc
from elevation_mapping_cupy_tpu.ops import stencil as jst

from elevation_mapping_cupy_torch import MapConfig
from elevation_mapping_cupy_torch.nn import traversability as ttrav
from elevation_mapping_cupy_torch.ops import geometry as tgeo
from elevation_mapping_cupy_torch.ops import pointcloud as tpc
from elevation_mapping_cupy_torch.ops import raycast as trc
from elevation_mapping_cupy_torch.ops import stencil as tst

# small map; polar pinned (a small map can resolve "auto" to the exact march)
CFG_KW = dict(
    resolution=0.1, map_length=4.0, max_ray_length=1.5, max_points=8192,
    raycast_mode="polar", enable_drift_compensation=False,
)
N_PTS = 8000
T3 = np.array([0.0, 0.0, 0.6], np.float32)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(rng, z_lo=-0.15, z_hi=0.25):
    pts = rng.uniform(-1.8, 1.8, (N_PTS, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(z_lo, z_hi, N_PTS)
    return pts


def _scene(slope_from_bins=True):
    """A JAX map after two fused frames and seven time steps, plus a ground
    sweep cloud whose rays shave the mapped cells (test_raycast_modes's
    scene), with the association and the fused layers both packages start
    the cleanup from."""
    rng = np.random.default_rng(7)
    jcfg = JaxConfig(**CFG_KW, raycast_slope_from_bins=slope_from_bins)
    w = jtrav.default_weights()
    R = jnp.eye(3)
    z0 = jnp.float32(0)
    state = jinit_state(jcfg)
    for _ in range(2):
        state = jcore.update_pointcloud(
            state, jnp.asarray(_cloud(rng)), jnp.ones(N_PTS, bool), R, jnp.asarray(T3), z0, z0, w, jcfg
        )
    for _ in range(7):
        state = jcore.update_time(state, jcfg)
    pts = _cloud(rng)
    pts[:, 2] = -0.55
    # a few walls of points so the normals and the wall gate are non-trivial
    pts[:400, 2] = rng.uniform(-0.5, 0.3, 400)
    return jcfg, state, pts


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _assoc_pair(jcfg, state, pts):
    mask = np.ones(len(pts), bool)
    mask[-50:] = False  # padding rows
    t_c = T3 - np.asarray(state.center)
    ja = jgeo.associate_points(jnp.asarray(pts), jnp.asarray(mask), jnp.eye(3), jnp.asarray(t_c), jcfg)
    ta = tgeo.associate_points(_t(pts), _t(mask), torch.eye(3), _t(t_c), MapConfig(**_kw(jcfg)))
    return ja, ta, t_c


def _kw(jcfg):
    import dataclasses

    return {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}


def test_associate_points_matches_jax(scene):
    jcfg, state, pts = scene
    ja, ta, _ = _assoc_pair(jcfg, state, pts)
    np.testing.assert_array_equal(ta.flat_idx.numpy(), np.asarray(ja.flat_idx))
    np.testing.assert_array_equal(ta.valid.numpy(), np.asarray(ja.valid))
    np.testing.assert_array_equal(ta.inside.numpy(), np.asarray(ja.inside))
    np.testing.assert_array_equal(ta.mask.numpy(), np.asarray(ja.mask))
    np.testing.assert_allclose(ta.world.numpy(), np.asarray(ja.world), atol=1e-5)
    np.testing.assert_allclose(ta.noise.numpy(), np.asarray(ja.noise), atol=1e-6)


def test_association_clamps_far_points():
    """Points far outside the map (and far beyond int32 cell range) clamp to
    the border cells as XLA's saturating cast does, and are not inside."""
    cfg_kw = dict(CFG_KW)
    jcfg = JaxConfig(**cfg_kw)
    pts = np.array([[1e9, -1e9, 0.1], [-3e3, 5.0, 0.0], [0.05, 0.05, 0.0]], np.float32)
    mask = np.ones(3, bool)
    ja = jgeo.associate_points(jnp.asarray(pts), jnp.asarray(mask), jnp.eye(3), jnp.zeros(3), jcfg)
    ta = tgeo.associate_points(_t(pts), _t(mask), torch.eye(3), torch.zeros(3), MapConfig(**cfg_kw))
    np.testing.assert_array_equal(ta.flat_idx.numpy(), np.asarray(ja.flat_idx))
    np.testing.assert_array_equal(ta.inside.numpy(), np.asarray(ja.inside))


@pytest.mark.parametrize("drift", [False, True])
def test_pointcloud_stages_match_jax(scene, drift):
    """error counting -> drift compensation -> fusion -> average -> overlap
    clearance: float layers within 2e-4 (summation order), counts exact."""
    jcfg, state, pts = scene
    jcfg = jcfg.replace(enable_drift_compensation=drift, min_height_drift_cnt=5.0)
    cfg = MapConfig(**_kw(jcfg))
    # a map whose cells pass the inlier test: low variance, high traversability
    layers_np = np.asarray(state.layers).copy()
    layers_np[1] = np.minimum(layers_np[1], 0.02)
    layers_np[3] = 0.95
    ja, ta, t_c = _assoc_pair(jcfg, state, pts)
    jl = jnp.asarray(layers_np)
    tl = _t(layers_np)

    jrows = jpc.gather_cell_rows(jl, ja.flat_idx)
    trows = tpc.gather_cell_rows(tl, ta.flat_idx)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))

    jc = jpc.error_counting(jl, ja, jcfg, jrows)
    tc = tpc.error_counting(tl, ta, cfg, trows)
    np.testing.assert_array_equal(tc.inlier_cnt.numpy(), np.asarray(jc.inlier_cnt))
    np.testing.assert_array_equal(tc.point_cnt.numpy(), np.asarray(jc.point_cnt))
    assert int(tc.error_cnt) == int(jc.error_cnt) > 0
    np.testing.assert_allclose(float(tc.error_sum), float(jc.error_sum), atol=2e-4, rtol=1e-5)

    pn = np.float32(0.5)
    jd = jpc.apply_drift_compensation(jl, jc, jnp.float32(pn), jnp.float32(0), jnp.float32(0.01), jnp.float32(0.02), jcfg)
    td = tpc.apply_drift_compensation(
        tl, tc, torch.tensor(pn), torch.tensor(0.0), torch.tensor(0.01), torch.tensor(0.02), cfg
    )
    for a, b in zip(td, jd):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)

    jf, jnew = jpc.point_fusion(jd[0], ja, jc.point_cnt, jcfg, jrows, jd[3])
    tf, tnew = tpc.point_fusion(td[0], ta, tc.point_cnt, cfg, trows, td[3])
    np.testing.assert_array_equal(tnew[2].numpy(), np.asarray(jnew[2]))  # counts
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), atol=2e-4)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-4)

    ja_avg = jpc.average_map(jf, jnew, jcfg)
    ta_avg = tpc.average_map(tf, tnew, cfg)
    np.testing.assert_allclose(ta_avg.numpy(), np.asarray(ja_avg), atol=2e-4)

    jo = jpc.clear_overlap(ja_avg, jnp.asarray(t_c), jcfg.replace(overlap_clear_range_z=0.3))
    to = tpc.clear_overlap(ta_avg, _t(t_c), cfg.replace(overlap_clear_range_z=0.3))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-4)


def test_dilation_fill_and_normals_match_jax(scene):
    _, state, _ = scene
    L = np.asarray(state.layers)
    for size in (1, 3):
        jh, jm = jst.dilation_fill(jnp.asarray(L[5]), jnp.asarray(L[2] + L[6]), size)
        th, tm = tst.dilation_fill(_t(L[5]), _t(L[2] + L[6]), size)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))  # exact
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jn = jst.surface_normals(jnp.asarray(L[0]), jnp.asarray(L[2]), 0.1)
    tn = tst.surface_normals(_t(L[0]), _t(L[2]), 0.1)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6)


def test_traversability_cnn_matches_jax(scene):
    """Shipped weights, f32 at full precision on both sides: 1e-5."""
    _, state, _ = scene
    L = np.asarray(state.layers)
    jw = jtrav.load_weights_npz(ttrav.DEFAULT_WEIGHT_FILE)
    tw = ttrav.load_weights_npz(ttrav.DEFAULT_WEIGHT_FILE)
    x = L[5] + np.random.default_rng(3).normal(0, 0.05, L[5].shape).astype(np.float32)
    np.testing.assert_allclose(
        tw(_t(x)).numpy(), np.asarray(jtrav.traversability_filter(jnp.asarray(x), jw)), atol=1e-5
    )


@pytest.mark.parametrize("slope_from_bins", [True, False])
def test_visibility_cleanup_polar_matches_jax(slope_from_bins):
    """The shadow cube on both packages from one fused map.

    Every layer within 1e-4 of JAX. Both compute in float32, but XLA:CPU's
    atan2/tan/sin/cos differ from PyTorch's by ulps; a ray or a cell right at
    a bin edge can land in the neighbouring bin. This scene puts none there,
    so the per-layer bound holds."""
    jcfg, state, pts = _scene(slope_from_bins)
    cfg = MapConfig(**_kw(jcfg))
    ja, ta, t_c = _assoc_pair(jcfg, state, pts)
    jc = jpc.error_counting(state.layers, ja, jcfg)
    jl, _ = jpc.point_fusion(state.layers, ja, jc.point_cnt, jcfg)
    a = np.asarray(jrc.visibility_cleanup_polar(jl, state.normal, ja, jc.inlier_cnt, jnp.asarray(t_c), jcfg))
    b = trc.visibility_cleanup_polar(
        _t(jl), _t(state.normal), ta, _t(jc.inlier_cnt), _t(t_c), cfg
    ).numpy()
    base = np.asarray(jl)
    assert (base[2] - a[2]).max() > 0.01  # the sweep does clean cells up
    assert (a[6] > base[6]).any()         # and writes upper bounds
    np.testing.assert_allclose(b, a, atol=1e-4)


def test_resolve_raycast_mode_and_exact_raises():
    for kw in (
        dict(),
        dict(max_ray_length=10.0),
        dict(resolution=0.1, map_length=3.0, max_ray_length=1.0, max_points=4096),
        dict(raycast_mode="exact"),
    ):
        assert trc.resolve_raycast_mode(MapConfig(**kw)) == jrc.resolve_raycast_mode(JaxConfig(**kw))
    # the exact march refuses an implementation it does not know
    cfg = MapConfig(raycast_mode="exact", raycast_exact_impl="dense")
    with pytest.raises(ValueError, match="raycast_exact_impl"):
        trc.visibility_cleanup(None, None, None, None, None, cfg)
