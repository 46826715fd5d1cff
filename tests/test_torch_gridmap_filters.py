"""The port's grid-map filter library (``ops/gridmap_filters.py``) against
the JAX package's, function by function, on maps with NaN holes made with
numpy from a seed. Every result is held within 1e-5 with NaN where JAX has
NaN; the min/max filters and the median are equal (they compute no new
value, or the mean of the same two).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elevation_mapping_cupy_tpu.ops import gridmap_filters as jgf

from elevation_mapping_cupy_torch.ops import gridmap_filters as gf

SHAPE = (19, 23)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _map(seed=0, shape=SHAPE, holes=True):
    """A sloped, bumpy height map with a few NaN holes (one large, several
    single cells, one at the border) as numpy float32."""
    rng = np.random.default_rng(seed)
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W]
    h = (0.05 * xx - 0.03 * yy + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    if holes:
        h[4:9, 6:12] = np.nan
        h[rng.integers(0, H, 8), rng.integers(0, W, 8)] = np.nan
        h[0, 3] = np.nan
        h[H - 2 :, W - 3 :] = np.nan
    return h


def _close(got, want, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("iterations", [0, 1, 3])
def test_inpaint_min_values_matches_jax(iterations):
    """The fixed point (iterations=0: every hole takes the minimum of its
    rim) and capped rounds; an all-NaN map stays NaN."""
    h = _map(1)
    got = gf.inpaint_min_values(_t(h), iterations)
    _close(got, jgf.inpaint_min_values(jnp.asarray(h), iterations), atol=0)
    if iterations == 0:
        assert np.isfinite(got.numpy()).all()
        nan = np.full((4, 5), np.nan, np.float32)
        assert np.isnan(gf.inpaint_min_values(_t(nan)).numpy()).all()


def test_inpaint_min_values_fixed_point_needs_many_rounds():
    """A hole that takes more rounds than the loop asks the device after:
    the same fixed point as the JAX while_loop."""
    h = _map(2, shape=(40, 7), holes=False)
    h[1:39, 1:6] = np.nan
    assert 38 > gf.FIXED_POINT_CHECK_EVERY
    _close(gf.inpaint_min_values(_t(h)), jgf.inpaint_min_values(jnp.asarray(h)), atol=0)


@pytest.mark.parametrize("iterations", [1, 32])
def test_inpaint_bilinear_matches_jax(iterations):
    h = _map(3)
    _close(gf.inpaint_bilinear(_t(h), iterations), jgf.inpaint_bilinear(jnp.asarray(h), iterations))


@pytest.mark.parametrize("out_shape", [(38, 46), (9, 11), (25, 17), (19, 23)])
def test_resample_matches_jax(out_shape):
    """Upscaling, downscaling, a mix of both and the identity: half-pixel
    centres, no antialiasing."""
    h = _map(4, holes=False)
    _close(gf.resample(_t(h), out_shape), jgf.resample(jnp.asarray(h), out_shape))


@pytest.mark.parametrize("size", [3, 5])
def test_median_filter_matches_nanmedian(size):
    """Windows with odd and even counts of finite values (an even count
    takes the mean of the middle two, where torch.nanmedian would take the
    lower) and an all-NaN window."""
    h = _map(5)
    h[10:15, 14:20] = np.nan  # a 5x6 hole: the centre's 3x3 window is all NaN
    got = gf.median_filter(_t(h), size)
    want = jgf.median_filter(jnp.asarray(h), size)
    _close(got, want, atol=0)
    # the even counts occur and are averaged, not the lower value taken
    p = np.pad(h, size // 2, mode="edge")
    win = np.stack([p[dy : dy + SHAPE[0], dx : dx + SHAPE[1]] for dy in range(size) for dx in range(size)])
    even = (np.isfinite(win).sum(0) % 2 == 0) & np.isfinite(win).any(0)
    assert even.any()
    lower = torch.nanmedian(_t(win), dim=0).values.numpy()
    assert (got.numpy()[even] != lower[even]).any()
    assert np.isnan(got.numpy()[12, 17])


@pytest.mark.parametrize("size, passes", [(3, 1), (5, 2)])
def test_box_blur_matches_jax(size, passes):
    h = _map(6)
    _close(gf.box_blur(_t(h), size, passes), jgf.box_blur(jnp.asarray(h), size, passes))


@pytest.mark.parametrize("size, sigma", [(5, 1.0), (3, 0.7), (7, 2.5)])
def test_gaussian_blur_matches_jax(size, sigma):
    h = _map(7)
    _close(gf.gaussian_blur(_t(h), size, sigma), jgf.gaussian_blur(jnp.asarray(h), size, sigma))


@pytest.mark.parametrize("size", [3, 5])
def test_shifted_window_stack_matches_jax(size):
    h = _map(8)
    _close(gf.shifted_window_stack(_t(h), size), jgf.shifted_window_stack(jnp.asarray(h), size), atol=0)


@pytest.mark.parametrize("op", ["dilate", "erode"])
@pytest.mark.parametrize("size, inpaint", [(3, False), (3, True), (5, True)])
def test_dilate_and_erode_match_jax(op, size, inpaint):
    h = _map(9)
    _close(getattr(gf, op)(_t(h), size, inpaint), getattr(jgf, op)(jnp.asarray(h), size, inpaint), atol=0)


def test_outline_matches_jax():
    m = np.isfinite(_map(10))
    got = gf.outline(_t(m))
    want = np.asarray(jgf.outline(jnp.asarray(m)))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want) and want.any()


def test_apply_kernel_function_matches_jax():
    """The cone dilation's use: a per-entry offset, then a NaN-aware max."""
    h = _map(11)
    k = 5
    offs = np.abs(np.arange(k * k) // k - k // 2) + np.abs(np.arange(k * k) % k - k // 2)
    got = gf.apply_kernel_function(
        _t(h), k, lambda s: torch.amax(torch.nan_to_num(s - _t(offs.astype(np.float32))[:, None, None], nan=-1e9), 0)
    )
    want = jgf.apply_kernel_function(
        jnp.asarray(h), k, lambda s: jnp.max(jnp.nan_to_num(s - jnp.asarray(offs, jnp.float32)[:, None, None], nan=-1e9), 0)
    )
    _close(got, want, atol=0)


@pytest.mark.parametrize("origin", [None, (0.3, -0.2)])
def test_values_and_max_between_locations_match_jax(origin):
    """Samples along a segment that leaves the map (clamped), the NaN-aware
    max, and a segment over NaN cells only."""
    h = _map(12)
    p0, p1 = np.array([-0.5, -0.9], np.float32), np.array([0.6, 1.4], np.float32)
    o_t = None if origin is None else _t(np.array(origin, np.float32))
    o_j = None if origin is None else jnp.asarray(origin, jnp.float32)
    args_t, args_j = (_t(h), _t(p0), _t(p1), 31, 0.1), (jnp.asarray(h), jnp.asarray(p0), jnp.asarray(p1), 31, 0.1)
    _close(gf.values_between_locations(*args_t, o_t), jgf.values_between_locations(*args_j, o_j), atol=0)
    _close(gf.max_value_between_locations(*args_t, o_t), jgf.max_value_between_locations(*args_j, o_j), atol=0)
    hole = np.full_like(h, np.nan)
    got = gf.max_value_between_locations(_t(hole), *args_t[1:], o_t)
    assert np.isnan(float(got)) and np.isnan(float(jgf.max_value_between_locations(jnp.asarray(hole), *args_j[1:], o_j)))


@pytest.mark.parametrize("margin", [0.0, 0.3, -1.0, 10.0])
def test_project_to_map_with_margin_matches_jax(margin):
    pos = np.array([[0.1, 0.2], [5.0, -7.0], [-3.1, 2.9], [1.0, 1.0]], np.float32)
    centre = np.array([0.5, -0.25], np.float32)
    got = gf.project_to_map_with_margin(_t(pos), _t(centre), (4.0, 3.0), margin)
    want = jgf.project_to_map_with_margin(jnp.asarray(pos), jnp.asarray(centre), (4.0, 3.0), margin)
    _close(got, want, atol=0)


def test_gradient_and_curvature_match_jax():
    h = _map(13)
    for g, w in zip(gf.estimate_gradient(_t(h), 0.04), jgf.estimate_gradient(jnp.asarray(h), 0.04)):
        _close(g, w)
    for g, w in zip(gf.estimate_gradient_and_curvature(_t(h), 0.04),
                    jgf.estimate_gradient_and_curvature(jnp.asarray(h), 0.04)):
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(np.asarray(w)))
        fin = np.isfinite(np.asarray(w))
        np.testing.assert_allclose(g.numpy()[fin], np.asarray(w)[fin], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 31, 257])
def test_unit_linspace_is_jax_linspace(n):
    """The segment samples are jnp.linspace(0, 1, n)'s to the bit."""
    want = np.asarray(jnp.linspace(0.0, 1.0, n))
    got = gf._unit_linspace(n, torch.float32, "cpu").numpy()
    assert got.shape == want.shape and np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_inpaint_min_values_matches_the_numpy_oracle():
    """The reference's C++ loop (tests/golden oracle) to its fixed point:
    a NaN region takes the minimum along its whole contour."""
    from .golden import reference_planeseg_numpy as oracle

    h = _map(14, shape=(32, 32))
    h[np.random.default_rng(14).random((32, 32)) < 0.25] = np.nan
    np.testing.assert_allclose(gf.inpaint_min_values(_t(h)).numpy(), oracle.min_values_inpaint(h), atol=1e-6)
    h2 = np.full((9, 9), np.nan, np.float32)
    h2[0, :], h2[-1, :] = 1.0, 0.25
    assert np.allclose(gf.inpaint_min_values(_t(h2)).numpy()[1:-1], 0.25)


@pytest.mark.parametrize("size", [3, 5])
def test_dilate_matches_the_numpy_oracle(size):
    from .golden import reference_planeseg_numpy as oracle

    h = _map(15, shape=(20, 20), holes=False)
    h[4:7, 9:12] = np.nan
    ref = oracle.apply_kernel_function(h, size, oracle._max_of_finites)
    ref = np.where(np.isnan(h), np.nan, np.where(np.isnan(ref), h, ref))
    np.testing.assert_allclose(gf.dilate(_t(h), size).numpy(), ref, atol=1e-6, equal_nan=True)
