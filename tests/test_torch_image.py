"""The port's image path (``ops/image.py``, ``core.input_image``) against the
JAX package, on the CPU: the projection with radtan distortion, both
occlusion modes, the three image fusions and the plane cursor.

``uv`` is held to 2e-3 pixels on the cells valid in both packages (the JAX
suite's tolerance against its loop golden, tests/test_image_path.py) and
``valid`` to agreement on at least 99.5 % of cells. XLA:CPU contracts some
multiply-adds into FMAs and its atan2/cos/sin round an ulp apart from
PyTorch's, so a cell at the very edge of the image, of an azimuth bin or of
an occluder's shadow can fall on the other side; each test prints how many
did in its assertion message (in these scenes: none, in either mode).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elevation_mapping_cupy_tpu import MapConfig as JaxConfig
from elevation_mapping_cupy_tpu import core as jcore
from elevation_mapping_cupy_tpu import init_state as jinit_state
from elevation_mapping_cupy_tpu.ops import image as jimage

from elevation_mapping_cupy_torch import MapConfig, core
from elevation_mapping_cupy_torch.ops import image as timage
from elevation_mapping_cupy_torch.state import state_from_numpy, state_to_numpy

CFG_KW = dict(resolution=0.1, map_length=4.0, max_points=256)
IMG_H, IMG_W = 48, 64
R_DOWN = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)  # camera looking down
K_CAM = np.array([[20, 0, 32], [0, 20, 24], [0, 0, 1]], np.float32)  # a wide lens: most of the map is in view
MIN_VALID_AGREEMENT = 0.995


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _scene_layers(rng, n):
    """A rough floor with two walls and a tenth of the cells unknown."""
    h = rng.uniform(-0.05, 0.05, (n, n)).astype(np.float32)
    h[12:15, 5:35] = 0.9
    h[25:28, 10:30] = 0.5
    layers = np.zeros((7, n, n), np.float32)
    layers[0] = h
    layers[2] = rng.uniform(0, 1, (n, n)) > 0.1
    return layers


def _camera(t, Rm, center, cfg):
    """P, the camera cell and its height as both packages' input_image
    compute them (core.py:206-211), on the host."""
    P = (K_CAM @ np.concatenate([Rm, t[:, None]], 1)).astype(np.float32)
    t_cam = (-Rm.T @ t - center).astype(np.float32)
    cell = np.floor(cfg.cell_n / 2 + t_cam[:2] / np.float32(cfg.resolution)).astype(np.int32)
    return P, cell, np.float32(t_cam[2])


CAMERAS = {
    # above the map's middle, a little off the cell grid
    "overhead": (np.array([0.23, -0.11, 1.2], np.float32), R_DOWN),
    # the camera cell lies outside the map (x1 > cell_n): every line leaves the grid
    "outside_the_map": (np.array([-2.9, 0.4, 1.6], np.float32), R_DOWN),
    # pitched 35 degrees: part of the map is behind the image plane
    "pitched": (np.array([0.5, 0.2, 1.0], np.float32),
                (R_DOWN @ np.array([[np.cos(0.6), 0, np.sin(0.6)], [0, 1, 0], [-np.sin(0.6), 0, np.cos(0.6)]])).astype(np.float32)),
}
DISTORTIONS = {
    "pinhole": np.zeros(5, np.float32),
    "radtan": np.array([0.01, -0.005, 0.001, 0.0005, 0.002], np.float32),
}


def _correspondence(mode, camera, distortion, seed=0):
    rng = np.random.default_rng(seed)
    kw = dict(CFG_KW, image_occlusion_mode=mode)
    jcfg, cfg = JaxConfig(**kw), MapConfig(**kw)
    layers = _scene_layers(rng, cfg.cell_n)
    center = np.array([0.1, -0.2, 0.05], np.float32)
    t, Rm = CAMERAS[camera]
    D = DISTORTIONS[distortion]
    P, cell, z1 = _camera(t, Rm, center, cfg)
    juv, jvalid = jimage.image_to_map_correspondence(
        jnp.asarray(layers), jnp.asarray(center), jnp.asarray(cell), jnp.float32(z1), jnp.asarray(P),
        jnp.asarray(K_CAM), jnp.asarray(D), jnp.float32(IMG_H), jnp.float32(IMG_W), jcfg,
    )
    tuv, tvalid = timage.image_to_map_correspondence(
        torch.from_numpy(layers), torch.from_numpy(center), torch.from_numpy(cell), torch.tensor(z1),
        torch.from_numpy(P), torch.from_numpy(K_CAM), torch.from_numpy(D), float(IMG_H), float(IMG_W), cfg,
    )
    return np.asarray(juv), np.asarray(jvalid), tuv.numpy(), tvalid.numpy(), cell, cfg


@pytest.mark.parametrize("distortion", list(DISTORTIONS))
@pytest.mark.parametrize("camera", list(CAMERAS))
@pytest.mark.parametrize("mode", ["shadow", "bresenham"])
def test_correspondence_matches_jax(mode, camera, distortion):
    juv, jvalid, tuv, tvalid, cell, cfg = _correspondence(mode, camera, distortion)
    n = cfg.cell_n
    assert tuv.shape == (2, n, n) and tvalid.shape == (n, n) and tvalid.dtype == bool
    differ = int((jvalid != tvalid).sum())
    msg = f"{mode}/{camera}/{distortion}: valid differs in {differ} of {n * n} cells ({int(jvalid.sum())} valid in JAX)"
    print(msg)
    assert differ <= (1 - MIN_VALID_AGREEMENT) * n * n, msg
    if mode == "bresenham":
        # the walk is integer arithmetic but for one compare against a ray
        # height built from correctly rounded roots: no cell may differ
        assert differ == 0, msg
    both = jvalid & tvalid
    assert both.sum() > 20, msg
    np.testing.assert_allclose(tuv[:, both], juv[:, both], atol=2e-3, err_msg=msg)
    # cells that are no candidate keep a zeroed uv in both
    assert ((tuv == 0).all(0) == (juv == 0).all(0)).mean() >= MIN_VALID_AGREEMENT
    in_image = (juv != 0).any(0)
    if camera == "overhead":
        # the scene is not trivial: the walls occlude cells that project into the image
        assert both.sum() > 400 and (in_image & ~jvalid).sum() > 20, msg
    if camera == "outside_the_map":
        assert cell[0] >= n
    if camera == "pitched":
        assert in_image.sum() < 0.6 * n * n  # half of the map is out of view or behind the camera


def test_bresenham_early_exit_changes_nothing(monkeypatch):
    """The walk stops once every cell is done; all 2*cell_n steps give the
    same mask."""
    _, _, _, valid_early, _, _ = _correspondence("bresenham", "overhead", "radtan", seed=3)
    monkeypatch.setattr(timage, "BRESENHAM_CHECK_EVERY", 10**9)  # only step 0 asks: never stops early
    _, _, _, valid_full, _, _ = _correspondence("bresenham", "overhead", "radtan", seed=3)
    np.testing.assert_array_equal(valid_early, valid_full)


def test_shadow_occlusion_agrees_with_bresenham_in_the_port():
    """The port's two modes against each other on the scene and camera of
    the JAX suite's own such test (tests/test_image_path.py:121), at its
    limits: under 6 % disagreement, IoU > 0.94."""
    rng = np.random.default_rng(7)
    cfg_b = MapConfig(**CFG_KW, image_occlusion_mode="bresenham")
    n = cfg_b.cell_n
    layers = _scene_layers(rng, n)
    K = np.array([[60, 0, 48], [0, 60, 36], [0, 0, 1]], np.float32)
    t = np.array([0.2, -0.1, 1.2], np.float32)
    P = (K @ np.concatenate([R_DOWN, t[:, None]], 1)).astype(np.float32)
    t_cam = -R_DOWN.T @ t
    cell = np.floor(n / 2 + t_cam[:2] / cfg_b.resolution).astype(np.int64)
    args = (torch.from_numpy(layers), torch.zeros(3), torch.from_numpy(cell), torch.tensor(t_cam[2]),
            torch.from_numpy(P), torch.from_numpy(K), torch.zeros(5), 72.0, 96.0)
    v_b = timage.image_to_map_correspondence(*args, cfg_b)[1].numpy()
    v_s = timage.image_to_map_correspondence(*args, cfg_b.replace(image_occlusion_mode="shadow"))[1].numpy()
    both = v_b | v_s
    assert v_b.sum() > 50
    assert (v_b != v_s).sum() / both.sum() < 0.06
    assert (v_b & v_s).sum() / both.sum() > 0.94


def _fusion_inputs(rng, n):
    uv = np.stack([rng.uniform(-3, IMG_W + 3, (n, n)), rng.uniform(-3, IMG_H + 3, (n, n))]).astype(np.float32)
    valid = rng.random((n, n)) > 0.4
    uv[:, ~valid] = 0.0
    image = rng.uniform(0, 255, (3, IMG_H, IMG_W)).astype(np.float32)
    prev = rng.normal(0, 1, (n, n)).astype(np.float32)
    return uv, valid, image, prev


@pytest.mark.parametrize("fusion", ["replace", "exponential", "color"])
def test_image_fusions_match_jax(fusion):
    """Each fusion on the same uv, mask, image and previous layer; uv
    reaches past the image's edges so that the clipped gather is covered."""
    rng = np.random.default_rng(5)
    uv, valid, image, prev = _fusion_inputs(rng, 42)
    j = [jnp.asarray(x) for x in (prev, image, uv, valid)]
    t = [torch.from_numpy(x) for x in (prev, image, uv, valid)]
    if fusion == "replace":
        want = jimage.image_fuse_replace(j[0], j[1][0], j[2], j[3], jnp.float32(IMG_W))
        got = timage.image_fuse_replace(t[0], t[1][0], t[2], t[3], float(IMG_W))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif fusion == "exponential":
        want = jimage.image_fuse_exponential(j[0], j[1][1], j[2], j[3], jnp.float32(IMG_W), 0.7)
        got = timage.image_fuse_exponential(t[0], t[1][1], t[2], t[3], float(IMG_W), 0.7)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    else:
        packed_prev = (rng.integers(0, 1 << 24, prev.shape).astype(np.uint32)).view(np.float32)
        want = jimage.image_fuse_color(jnp.asarray(packed_prev), j[1], j[2], j[3], jnp.float32(IMG_W))
        got = timage.image_fuse_color(torch.from_numpy(packed_prev), t[1], t[2], t[3], float(IMG_W))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        assert (_bits(got.numpy())[~valid] == packed_prev.view(np.uint32)[~valid]).all()
    assert (got.numpy()[valid] != prev[valid]).mean() > 0.9


IMAGE_TABLE = (("rgb", "color"), ("mask", "exponential"), ("seg", "average"))


@pytest.mark.parametrize("mode", ["shadow", "bresenham"])
def test_input_image_plane_cursor_matches_jax(mode):
    """A colour channel before two mono ones: 'rgb' takes planes 0-2, 'mask'
    plane 3 and 'seg' plane 4 (tests/test_image_path.py:160). The whole
    state against JAX, two calls in a row (the exponential layer moves on)."""
    rng = np.random.default_rng(6)
    kw = dict(CFG_KW, image_occlusion_mode=mode, semantic_layers=("mask", "rgb", "seg", "alpha"),
              image_channel_fusions=IMAGE_TABLE,
              pointcloud_channel_fusions=(("alpha", "class_bayesian"), ("default", "class_average")))
    jcfg, cfg = JaxConfig(**kw), MapConfig(**kw)
    n = cfg.cell_n
    arrays = {k: np.array(v) for k, v in jinit_state(jcfg)._asdict().items()}
    arrays["layers"] = _scene_layers(rng, n)
    arrays["center"] = np.array([0.1, -0.2, 0.05], np.float32)
    arrays["sem_new"] = rng.uniform(0.5, 1, (4, n, n)).astype(np.float32)
    js = type(jinit_state(jcfg))(**{k: jnp.asarray(v) for k, v in arrays.items()})
    ts = state_from_numpy(arrays, "cpu")
    t, Rm = CAMERAS["overhead"]
    channels = ("rgb", "mask", "seg")
    for call in range(2):
        img = np.stack([np.full((IMG_H, IMG_W), v, np.float32) for v in (51.0, 102.0, 153.0, 0.9, 0.3)])
        img += rng.uniform(0, 0.05, img.shape).astype(np.float32)
        js = jcore.input_image(js, jnp.asarray(img), jnp.asarray(Rm), jnp.asarray(t), jnp.asarray(K_CAM),
                               jnp.zeros(5), jcfg, channels)
        ts = core.input_image(ts, torch.from_numpy(img), torch.from_numpy(Rm), torch.from_numpy(t),
                              torch.from_numpy(K_CAM), torch.zeros(5), cfg, channels)
        got = state_to_numpy(ts)
        sem_j = np.asarray(js.semantic)
        touched = sem_j[0] != 0
        agree = (got["semantic"][0] != 0) == touched
        msg = f"{mode} call {call}: touched cells differ in {int((~agree).sum())} of {n * n}"
        assert agree.mean() >= MIN_VALID_AGREEMENT and touched.sum() > 100, msg
        for lay, tol in ((0, 1e-4), (2, 0)):
            np.testing.assert_allclose(got["semantic"][lay][agree], sem_j[lay][agree], atol=tol, err_msg=msg)
        np.testing.assert_array_equal(_bits(got["semantic"][1])[agree], _bits(sem_j[1])[agree], err_msg=msg)
        for name in ("layers", "normal", "sem_new", "id_max", "center"):
            np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)), err_msg=name)
    sem = got["semantic"]
    both = (sem[0] != 0) & (sem[2] != 0)
    a = cfg.image_exponential_alpha
    # mask read plane 3 twice (0.9..0.95), not plane 1 (102): a*v then (1-a)*a*v + a*v'
    assert sem[0][both].min() > a * 0.9 * (2 - a) - 1e-3 and sem[0][both].max() < a * 0.95 * (2 - a) + 1e-3
    assert sem[2][both].min() >= 0.3 and sem[2][both].max() <= 0.35
    r, g, b = (_bits(sem[1])[both] >> s & 0xFF for s in (16, 8, 0))
    assert set(np.unique(r)) == {51} and set(np.unique(g)) == {102} and set(np.unique(b)) == {153}
    # the persistent (Dirichlet) row of sem_new survived both calls, the others were reset
    assert (got["sem_new"][3] == arrays["sem_new"][3]).all() and not got["sem_new"][:3].any()
