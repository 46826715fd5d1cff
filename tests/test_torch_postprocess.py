"""The port's plane-segmentation pre- and postprocessing against the JAX
package's and the real-OpenCV oracle (tests/golden/reference_planeseg_numpy.py),
test for test of ``tests/test_postprocess.py``, on the same seeded inputs,
on the CPU.

Tolerances: the footprints and taps equal; preprocessing bit for bit
without a resample (inpainting and the median pick values, they compute
none) and within 1e-6 of JAX with one; the smooth layer and postprocess
within 1e-6 of JAX (the same sums in the same order; the box filter's
quotient may round apart); against the oracle, the JAX tests' tolerances.
"""

import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elevation_mapping_cupy_tpu.ops import gridmap_filters as jgmf
from elevation_mapping_cupy_tpu.planeseg import extract as JE
from elevation_mapping_cupy_tpu.planeseg import postprocess as jpp
from elevation_mapping_cupy_tpu.planeseg.pipeline import PlaneDecompositionPipeline as JPipeline

from elevation_mapping_cupy_torch.ops import gridmap_filters as gmf
from elevation_mapping_cupy_torch.planeseg import postprocess as pp
from elevation_mapping_cupy_torch.planeseg.extract import (
    PreprocessingParams,
    preprocess,
    resample_shape,
    true_resolution,
)
from elevation_mapping_cupy_torch.planeseg.pipeline import PlaneDecompositionPipeline

from .golden import reference_planeseg_numpy as oracle

RES = 0.04
JAX_TOL = 1e-6


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def make_terrain(n=40, seed=0, nan_frac=0.15):
    """Steps + ramp + noise + NaN holes."""
    rng = np.random.default_rng(seed)
    h = rng.normal(0.0, 0.01, (n, n)).astype(np.float32)
    h[: n // 2, : n // 2] += 0.3
    h[n // 2 :, n // 2 :] += np.linspace(0, 0.2, n // 2)[None, :]
    holes = rng.random((n, n)) < nan_frac
    holes[3:8, 3:8] = True  # one solid hole region
    h[holes] = np.nan
    return h


def make_mask(n=40, seed=1):
    rng = np.random.default_rng(seed)
    m = (rng.random((n, n)) < 0.7).astype(np.float32)
    m[10:20, 10:20] = 0.0  # one solid non-planar block
    m[25:35, 5:15] = 1.0
    return m


def _bits_equal(got, want):
    np.testing.assert_array_equal(np.ascontiguousarray(got, np.float32).view(np.uint32),
                                  np.ascontiguousarray(want, np.float32).view(np.uint32))


def test_ellipse_kernel_matches_opencv():
    for size in (3, 5, 7, 9, 11, 13):
        ours = pp.ellipse_kernel(size)
        cv = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))
        np.testing.assert_array_equal(ours.astype(np.uint8), cv, err_msg=f"size {size}")
        np.testing.assert_array_equal(ours, jpp.ellipse_kernel(size))


def test_gaussian_kernel_matches_opencv():
    for size in (3, 5, 7):
        ours = pp.gaussian_kernel_cv(size, 0.0)
        cv = cv2.getGaussianKernel(size, 0)[:, 0]
        np.testing.assert_allclose(ours, cv, atol=1e-7, err_msg=f"size {size}")
        np.testing.assert_array_equal(ours, jpp.gaussian_kernel_cv(size, 0.0))
    for size, sigma in ((9, 0.0), (5, 1.3)):
        np.testing.assert_array_equal(pp.gaussian_kernel_cv(size, sigma), jpp.gaussian_kernel_cv(size, sigma))


def test_inpaint_min_values_matches_reference_fixed_point():
    h = make_terrain(32, seed=3, nan_frac=0.25)
    ours = gmf.inpaint_min_values(_t(h)).numpy()
    ref = oracle.min_values_inpaint(h)
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    _bits_equal(ours, np.asarray(jgmf.inpaint_min_values(jnp.asarray(h))))
    # the defining property: a NaN-connected region takes the MIN along its
    # whole contour, not the nearest contour value
    h2 = np.full((9, 9), np.nan, np.float32)
    h2[0, :] = 1.0
    h2[-1, :] = 0.25
    ours2 = gmf.inpaint_min_values(_t(h2)).numpy()
    assert np.allclose(ours2[1:-1], 0.25)


def test_shifted_window_ops_match_loops(rng):
    h = rng.normal(0, 0.2, (20, 20)).astype(np.float32)
    h[4:7, 9:12] = np.nan
    for size in (3, 5):
        ours = gmf.dilate(_t(h), size).numpy()
        ref = oracle.apply_kernel_function(h, size, oracle._max_of_finites)
        ref = np.where(np.isnan(h), np.nan, np.where(np.isnan(ref), h, ref))
        np.testing.assert_allclose(ours, ref, atol=1e-6, equal_nan=True)
        _bits_equal(ours, np.asarray(jgmf.dilate(jnp.asarray(h), size)))


def test_preprocess_matches_oracle_no_resample():
    h = make_terrain(40)
    ours = preprocess(_t(h), kernel_size=3, median_passes=2).numpy()
    ref, res = oracle.preprocess(h, RES, oracle.PreprocessingParams(-1.0, 3, 2))
    assert res == RES
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    _bits_equal(ours, np.asarray(JE.preprocess(jnp.asarray(h), kernel_size=3, median_passes=2)))
    # the 5x5 median (a sort of 25 values) as well
    _bits_equal(preprocess(_t(h), kernel_size=5).numpy(), np.asarray(JE.preprocess(jnp.asarray(h), kernel_size=5)))


@pytest.mark.parametrize("target", [0.08, 0.05])
def test_preprocess_resample_matches_opencv(target):
    h = make_terrain(40)
    ref, ref_res = oracle.preprocess(h, RES, oracle.PreprocessingParams(target, 3, 1))
    out_shape = resample_shape(h.shape, RES, target)
    assert ref.shape == out_shape
    ours_res = true_resolution(h.shape, RES, out_shape)
    assert abs(ours_res - ref_res) < 1e-9
    pre = preprocess(_t(h), kernel_size=3, median_passes=1)
    ours = gmf.resample(pre, out_shape).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    jpre = JE.preprocess(jnp.asarray(h), kernel_size=3, median_passes=1)
    np.testing.assert_allclose(ours, np.asarray(jgmf.resample(jpre, out_shape)), rtol=0, atol=JAX_TOL)


def test_add_smooth_layer_matches_oracle():
    n = 40
    h = make_terrain(n)
    elev = oracle.min_values_inpaint(h)  # postprocess runs on inpainted maps
    mask = make_mask(n)
    params = pp.PostprocessingParams()
    ours = pp.add_smooth_layer(_t(elev), _t(mask), RES, params).numpy()
    ref = oracle.add_smooth_layer(elev, mask, RES, oracle.PostprocessingParams())
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    want = np.asarray(jpp.add_smooth_layer(jnp.asarray(elev), jnp.asarray(mask), RES, jpp.PostprocessingParams()))
    np.testing.assert_allclose(ours, want, rtol=0, atol=JAX_TOL)


def test_postprocess_matches_oracle():
    n = 40
    h = make_terrain(n, seed=7)
    elev = oracle.min_values_inpaint(h)
    mask = make_mask(n, seed=8)
    kw = dict(extracted_planes_height_offset=0.05, nonplanar_height_offset=0.03, nonplanar_horizontal_offset=2)
    for ours_p, ref_p, jax_p in [
        (pp.PostprocessingParams(), oracle.PostprocessingParams(), jpp.PostprocessingParams()),
        (pp.PostprocessingParams(**kw), oracle.PostprocessingParams(**kw), jpp.PostprocessingParams(**kw)),
    ]:
        ours_e, ours_s = pp.postprocess(_t(elev), _t(mask), RES, ours_p)
        ref_e, ref_s = oracle.postprocess(elev, mask, RES, ref_p)
        np.testing.assert_allclose(ours_e.numpy(), ref_e, atol=1e-4)
        np.testing.assert_allclose(ours_s.numpy(), ref_s, atol=1e-4)
        want_e, want_s = jpp.postprocess(jnp.asarray(elev), jnp.asarray(mask), RES, jax_p)
        np.testing.assert_allclose(ours_e.numpy(), np.asarray(want_e), rtol=0, atol=JAX_TOL)
        np.testing.assert_allclose(ours_s.numpy(), np.asarray(want_s), rtol=0, atol=JAX_TOL)
    # a batch of maps is each map on its own
    elevs, masks = np.stack([elev, elev[::-1]]), np.stack([mask, mask[:, ::-1]])
    be, bs = pp.postprocess(_t(elevs), _t(masks), RES)
    for b in range(2):
        e, s = pp.postprocess(_t(elevs[b]), _t(masks[b]), RES)
        _bits_equal(be[b].numpy(), e.numpy())
        _bits_equal(bs[b].numpy(), s.numpy())


def test_pipeline_resamples_and_postprocesses():
    """End-to-end: 0.04 m map, 0.08 m target → grid halves, postprocessed
    layers match the oracle run at the pipeline's own mask, and the JAX
    pipeline's."""
    n = 48
    rng = np.random.default_rng(5)
    h = rng.normal(0, 0.002, (n, n)).astype(np.float32)
    h[: n // 2] += 0.3
    h[10, 12] = np.nan
    pipe = PlaneDecompositionPipeline(
        resolution=RES, preprocessing=PreprocessingParams(resolution=0.08), device="cpu",
    )
    terrain = pipe.update(h)
    assert terrain.labels.shape == (n // 2, n // 2)
    assert abs(terrain.resolution - 0.08) < 1e-9
    assert len(terrain.regions) == 2
    assert np.isfinite(terrain.elevation).all()
    ref_e, ref_s = oracle.postprocess(
        terrain.filtered_map, terrain.plane_classification, terrain.resolution,
        oracle.PostprocessingParams(),
    )
    np.testing.assert_allclose(terrain.elevation, ref_e, atol=1e-4)
    np.testing.assert_allclose(terrain.smooth_planar, ref_s, atol=1e-4)
    nonplanar = terrain.plane_classification == 0.0
    assert nonplanar.any() and (~nonplanar).any()
    delta = terrain.elevation - terrain.filtered_map
    assert np.all(delta[nonplanar] >= 0.02 - 1e-5)
    want = JPipeline(resolution=RES, preprocessing=JE.PreprocessingParams(resolution=0.08)).update(h)
    np.testing.assert_array_equal(terrain.labels, want.labels)
    for name in ("filtered_map", "elevation", "smooth_planar"):
        np.testing.assert_allclose(getattr(terrain, name), getattr(want, name), rtol=0, atol=JAX_TOL, err_msg=name)
