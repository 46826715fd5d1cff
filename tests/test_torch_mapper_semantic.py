"""The port's ``ElevationMap(device="cpu")`` with semantic layers against the
JAX mapper: a trajectory with ``configs/semantic_mem.yaml``'s layers and
fusion tables, an image, the exports, checkpoints crossing between the
packages, and the bit-packed layers' round trips.

Float layers are held to the 1e-4 of the geometric mapper test
(tests/test_torch_core.py); packed colour layers and class ids must agree
bit for bit.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests import torch_scenes
from elevation_mapping_cupy_tpu import load_config as jload_config
from elevation_mapping_cupy_tpu.mapper import ElevationMap as JaxMap

from elevation_mapping_cupy_torch import load_config
from elevation_mapping_cupy_torch.mapper import ElevationMap
from elevation_mapping_cupy_torch.state import state_from_numpy, state_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEM_YAML = os.path.join(REPO, "configs", "semantic_mem.yaml")
SMALL = dict(resolution=0.1, map_length=4.0, max_ray_length=1.5, max_points=4096, raycast_mode="polar")
CORE = ["elevation", "variance", "is_valid", "traversability", "upper_bound", "normal_z"]
CHANNELS = ["x", "y", "z", "rgb", "grass", "tree", "person"]
K_CAM = np.array([[20, 0, 32], [0, 20, 24], [0, 0, 1]], np.float32)
R_DOWN = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _semantic_cloud(rng, k, n=3000):
    R, t, pos = torch_scenes.robot_pose(4 * k)
    pts = torch_scenes.scene_cloud(rng, n, R, t, r_max=2.5)
    cloud = np.concatenate(
        [pts, torch_scenes.pack_rgb(rng.integers(0, 256, (n, 3)))[:, None], rng.uniform(0, 1, (n, 3)).astype(np.float32)], axis=1
    )
    cloud[::97, :3] = np.nan  # the mapper drops NaN rows
    return cloud, R, t, pos


def _maps(**overrides):
    kw = dict(SMALL, **overrides)
    return JaxMap(jload_config(MEM_YAML, **kw)), ElevationMap(load_config(MEM_YAML, **kw), device="cpu")


def _drive(jem, tem, rng, frames=3):
    for k in range(frames):
        cloud, R, t, pos = _semantic_cloud(rng, k)
        for em in (jem, tem):
            em.move_to(pos, R)
            em.input_pointcloud(cloud, CHANNELS, R, t, 0.0, 0.0)


def _assert_exports_match(jem, tem, names, colour=("rgb",)):
    want, got = jem.get_layers(names), tem.get_layers(names)
    assert list(got) == list(want)
    for name in names:
        assert got[name].shape == want[name].shape and got[name].dtype == np.float32
        if name in colour:
            np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]), err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want[name], atol=1e-4, err_msg=name)
    return got


def test_semantic_trajectory_image_and_exports_match_jax_mapper():
    """Three frames of rgb + three class channels while the robot crosses
    whole cells, then one image (rgb planes and a mask that grows a layer):
    every core and semantic export against the JAX mapper."""
    rng = np.random.default_rng(40)
    jem, tem = _maps()
    assert tem.cfg == load_config(MEM_YAML, **SMALL) and tem.cfg.semantic_layers == ("rgb", "grass", "tree", "person")
    _drive(jem, tem, rng)
    sem = ["rgb", "grass", "tree", "person"]
    got = _assert_exports_match(jem, tem, CORE + sem)
    n = tem.cell_n
    assert got["grass"].shape == (n - 2, n - 2) and not np.isnan(got["grass"]).any()  # cropped, no NaN masking
    assert np.count_nonzero(got["rgb"]) > 300 and np.count_nonzero(got["person"]) > 300
    assert (_bits(got["rgb"]) >> 24 == 0).all()
    np.testing.assert_array_equal(state_to_numpy(tem.state)["id_max"], np.asarray(jem.state.id_max))

    img = np.stack([np.full((48, 64), v, np.float32) for v in (30.0, 60.0, 90.0, 0.8)])
    img += rng.uniform(0, 0.1, img.shape).astype(np.float32)
    t_cam = np.array([-0.1, 0.05, 1.4], np.float32)
    for em in (jem, tem):
        em.input_image(img, ["rgb", "mask"], R_DOWN, t_cam, K_CAM, np.zeros(5))
    assert tem.cfg.semantic_layers == jem.cfg.semantic_layers == tuple(sem) + ("mask",)
    assert tem.exists_layer("mask") and not tem.exists_layer("sky")
    got = _assert_exports_match(jem, tem, sem + ["mask"])
    assert np.count_nonzero(got["mask"]) > 200
    seen = got["mask"] != 0
    assert set(np.unique(_bits(got["rgb"])[seen] >> 16)) == {30}  # the image's red, not the cloud's
    buf = np.full((n - 2, n - 2), 7.0, np.float32)
    tem.get_map_with_name_ref("rgb", buf)
    np.testing.assert_array_equal(_bits(buf), _bits(got["rgb"]))
    tem.get_map_with_name_ref("sky", buf)  # unknown: says so, leaves the buffer
    np.testing.assert_array_equal(_bits(buf), _bits(got["rgb"]))


def test_layers_grow_on_first_sight_and_between_updates():
    """A map configured without semantic layers takes an x/y/z cloud, then
    clouds with channels: layers are grown in channel order as the JAX
    mapper grows them; a channel that no table entry maps gets none."""
    rng = np.random.default_rng(41)
    table = (("rgb", "color"), ("g.*", "class_average"), ("t.*", "class_bayesian"), ("p.*", "class_max"))
    jem, tem = _maps(semantic_layers=(), pointcloud_channel_fusions=table)
    cloud, R, t, pos = _semantic_cloud(rng, 0)
    cloud[:, 6] = torch_scenes.pack_class(rng.uniform(0.2, 1, len(cloud)), rng.integers(1, 4, len(cloud)))
    cloud = np.concatenate([cloud, rng.uniform(0, 1, (len(cloud), 1)).astype(np.float32)], 1)
    names = CHANNELS + ["unmapped"]
    for em in (jem, tem):
        em.input_pointcloud(cloud[:, :3], names[:3], R, t, 0.0, 0.0)
        assert em.state.semantic.shape[0] == 0
        em.input_pointcloud(cloud[:, :5], names[:5], R, t, 0.0, 0.0)
        assert tuple(em.cfg.semantic_layers) == ("rgb", "grass")
        em.input_pointcloud(cloud, names, R, t, 0.0, 0.0)
    assert tem.cfg.semantic_layers == jem.cfg.semantic_layers == ("rgb", "grass", "tree", "person")
    assert tem.semantic_layer_names == ["rgb", "grass", "tree", "person"]
    assert tem.state.id_max.dtype == torch.int64 and tem.state.id_max.shape == (4, tem.cell_n, tem.cell_n)
    _assert_exports_match(jem, tem, ["elevation", "rgb", "grass", "tree", "person"])
    got = state_to_numpy(tem.state)
    np.testing.assert_array_equal(got["id_max"], np.asarray(jem.state.id_max))
    assert set(np.unique(got["id_max"][3])) <= {0, 1, 2, 3} and got["id_max"][3].max() == 3
    np.testing.assert_allclose(got["sem_new"], np.asarray(jem.state.sem_new), atol=1e-3)


def test_semantic_checkpoints_cross_packages(tmp_path):
    """JAX -> port -> JAX with semantic layers: the loading map takes the
    file's layer names; every field, colour bits and ids included, arrives
    bit for bit; the loaded maps go on updating alike."""
    rng = np.random.default_rng(42)
    jem, tem = _maps()
    _drive(jem, tem, rng, frames=1)
    # ids past 2^31 and NaN-patterned packed values must survive too
    weird = jem.state.id_max.at[1, :2, :2].set(jnp.uint32(0xFFFFFFF0))
    packed = np.asarray(jem.state.semantic).copy()
    packed[1, 0, :4] = np.array([0x7FC00001, 0xFF800000, 0x00000001, 0x80000000], np.uint32).view(np.float32)
    jem.state = jem.state._replace(id_max=weird, semantic=jnp.asarray(packed))
    jem.save_checkpoint(str(tmp_path / "from_jax"))

    fresh = ElevationMap(load_config(MEM_YAML, **dict(SMALL, semantic_layers=())), device="cpu")
    fresh.load_checkpoint(str(tmp_path / "from_jax"))
    assert fresh.cfg.semantic_layers == ("rgb", "grass", "tree", "person")
    got = state_to_numpy(fresh.state)
    for name in jem.state._fields:
        want = np.asarray(getattr(jem.state, name))
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name].view(np.uint32), want.view(np.uint32), err_msg=name)

    fresh.save_checkpoint(str(tmp_path / "from_torch.npz"))
    jem2 = JaxMap(jload_config(MEM_YAML, **dict(SMALL, semantic_layers=())))
    jem2.load_checkpoint(str(tmp_path / "from_torch.npz"))
    assert jem2.cfg.semantic_layers == ("rgb", "grass", "tree", "person")
    for name in jem.state._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(jem2.state, name)).view(np.uint32), np.asarray(getattr(jem.state, name)).view(np.uint32),
            err_msg=name,
        )
    # the port's own checkpoint of its trajectory state equals that state
    tem.save_checkpoint(str(tmp_path / "own"))
    again = ElevationMap(tem.cfg, device="cpu")
    again.load_checkpoint(str(tmp_path / "own"))
    for name, a in state_to_numpy(again.state).items():
        np.testing.assert_array_equal(a.view(np.uint32), state_to_numpy(tem.state)[name].view(np.uint32), err_msg=name)
    # and both loaded maps take the next frame alike (rows 0 of the
    # patterned layer aside, which class_average would do arithmetic on)
    jem2.state = jem2.state._replace(semantic=jem2.state.semantic.at[1, 0, :4].set(0.0))
    sem = fresh.state.semantic.clone()
    sem[1, 0, :4] = 0.0
    fresh.state = fresh.state._replace(semantic=sem)
    cloud, R, t, pos = _semantic_cloud(rng, 1)
    for em in (jem2, fresh):
        em.move_to(pos, R)
        em.input_pointcloud(cloud, CHANNELS, R, t, 0.0, 0.0)
    _assert_exports_match(jem2, fresh, ["elevation", "rgb", "grass", "person"])


def test_packed_layers_survive_every_move_bit_for_bit():
    """Colour (denormal) and class-max (NaN- and infinity-patterned) values
    through state_from_numpy / state_to_numpy, move_to, the exports and
    clear-free maintenance steps: moved, never computed on or flushed."""
    rng = np.random.default_rng(43)
    cfg = load_config(MEM_YAML, **dict(SMALL, semantic_layers=("rgb", "cmax")))
    tem = ElevationMap(cfg, device="cpu")
    n = tem.cell_n
    arrays = state_to_numpy(tem.state)
    colour = torch_scenes.pack_rgb(rng.integers(0, 256, (n, n, 3)))
    cmax = ((rng.integers(0, 1 << 16, (n, n)).astype(np.uint32) << 16) | rng.integers(0, 1 << 16, (n, n)).astype(np.uint32))
    cmax[0, :3] = [0x7F800000, 0x7FC00000, 0xFFFFFFFF]
    arrays["semantic"] = np.stack([colour, cmax.view(np.float32)])
    arrays["id_max"] = rng.integers(0, 1 << 32, (2, n, n), dtype=np.uint64).astype(np.uint32)
    tem.state = state_from_numpy(arrays, "cpu")
    back = state_to_numpy(tem.state)
    np.testing.assert_array_equal(_bits(back["semantic"]), _bits(arrays["semantic"]))
    np.testing.assert_array_equal(back["id_max"], arrays["id_max"])

    out = tem.get_layers(["rgb", "cmax"])
    for i, name in enumerate(("rgb", "cmax")):
        np.testing.assert_array_equal(_bits(out[name]), _bits(arrays["semantic"][i][1:-1, 1:-1][::-1, ::-1]))
    tem.move_to(np.array([0.3, -0.2, 0.1], np.float32), np.eye(3, dtype=np.float32))  # 3 cells, -2 cells
    tem.update_time()
    tem.update_variance()
    moved = state_to_numpy(tem.state)
    want = np.roll(arrays["semantic"], (-3, 2), axis=(1, 2))
    np.testing.assert_array_equal(_bits(moved["semantic"])[:, :-3, 2:], _bits(want)[:, :-3, 2:])
    assert not moved["semantic"][:, -3:, :].any() and not moved["semantic"][:, :, :2].any()
    np.testing.assert_array_equal(moved["id_max"][:, :-3, 2:], np.roll(arrays["id_max"], (-3, 2), axis=(1, 2))[:, :-3, 2:])


@pytest.mark.parametrize("form", ["list_of_planes", "mono_2d", "four_distortion_terms", "other_model"])
def test_input_image_argument_forms_match_jax(form):
    """The mapper's image and distortion handling: a list of planes is
    stacked, a 2-D image is one mono plane, D is padded or cut to five
    terms, and a model other than radtan zeroes it."""
    rng = np.random.default_rng(44)
    jem, tem = _maps(semantic_layers=())
    for em in (jem, tem):
        em.state = em.state._replace(layers=_valid_floor(em, rng))
        rng = np.random.default_rng(44)
    img = rng.uniform(0, 255, (4, 48, 64)).astype(np.float32)
    D5 = np.array([0.01, -0.005, 0.001, 0.0005, 0.002], np.float32)
    t_cam = np.array([0.0, 0.0, 1.2], np.float32)
    if form == "list_of_planes":
        args, kw = ([img[0], img[1], img[2], img[3]], ["rgb", "mask"]), {}
    elif form == "mono_2d":
        args, kw = (img[3], ["mask"]), {}
    elif form == "four_distortion_terms":
        args, kw = (img, ["rgb", "mask"]), dict(D=D5[:4])
    else:
        args, kw = (img, ["rgb", "mask"]), dict(D=np.concatenate([D5, [0.3]]), distortion_model="equidistant")
    D = kw.pop("D", np.zeros(5, np.float32))
    for em in (jem, tem):
        em.input_image(*args, R_DOWN, t_cam, K_CAM, D, **kw)
    names = list(tem.cfg.semantic_layers)
    assert names == list(jem.cfg.semantic_layers) == args[1]
    got = _assert_exports_match(jem, tem, names)
    assert np.count_nonzero(got["mask"]) > 300


def _valid_floor(em, rng):
    """The map's layer stack with a rough, fully valid floor, in the
    package's own array type."""
    n = em.cell_n
    layers = np.array(state_to_numpy(em.state)["layers"] if isinstance(em, ElevationMap) else em.state.layers)
    layers[0] = rng.uniform(-0.03, 0.03, (n, n))
    layers[2] = 1.0
    return torch.from_numpy(layers) if isinstance(em, ElevationMap) else jnp.asarray(layers)
