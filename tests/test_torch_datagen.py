"""The port's datagen (``runtime/datagen.py``) against the JAX package's.

``jax.random``'s bits cannot be drawn by a ``torch.Generator``, so the port
splits every function into its draws and the deterministic work on them.
Here the draws JAX made (the same keys, split the same way) go through the
port's deterministic half, which must give JAX's result bit for bit. The
port's own draws are checked for shape, range, statistics and seeding.
"""

import math

import numpy as np
import pytest
import torch

from elevation_mapping_cupy_torch.runtime import datagen as td

RES = 0.04


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _jax():
    import jax
    import jax.numpy as jnp

    from elevation_mapping_cupy_tpu.runtime import datagen as jd

    return jax, jnp, jd


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("cells,scale", [(202, 50), (202, 67), (64, 16), (64, 2), (22, 3)])
def test_value_noise_matches_jax_bits(cells, scale):
    jax, jnp, jd = _jax()
    key = jax.random.PRNGKey(cells + scale)
    lattice = jax.random.uniform(key, (cells // scale + 2, cells // scale + 2), minval=-1.0, maxval=1.0)
    want = np.asarray(jd._value_noise(key, (cells, cells), scale))
    got = td.value_noise(_t(lattice), (cells, cells), scale).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _jax_terrain_lattices(jax, key, cells, n_octaves=3):
    """The lattices procedural_terrain draws: keys[i] per octave, keys[-2]
    for the terraces."""
    keys = jax.random.split(key, n_octaves + 2)
    chosen = list(keys[:n_octaves]) + [keys[-2]]
    return [
        _t(jax.random.uniform(k, shape, minval=-1.0, maxval=1.0))
        for k, shape in zip(chosen, td.terrain_lattice_shapes(cells, n_octaves))
    ]


def _jax_cloud_draws(jax, key, n):
    """The draws simulate_depth_cloud makes from ``key``, as the port's
    CloudDraws."""
    import jax.numpy as jnp

    k1, k2, k3 = jax.random.split(key, 3)
    ang = jax.random.uniform(k1, (n,), minval=0, maxval=2 * jnp.pi)
    return td.CloudDraws(
        cos_az=_t(jnp.cos(ang)), sin_az=_t(jnp.sin(ang)),
        radius_u=_t(jax.random.uniform(k2, (n,))), noise=_t(jax.random.normal(k3, (n,))),
    )


def _jax_batch_draws(jax, key, batch, cells, n):
    """The draws make_batch_clouds makes from ``key`` (a key a map, split
    into the terrain's and the cloud's), as the port's BatchDraws."""
    lattices, clouds = [], []
    for k in jax.random.split(key, batch):
        k1, k2 = jax.random.split(k)
        lattices.append(_jax_terrain_lattices(jax, k1, cells))
        clouds.append(_jax_cloud_draws(jax, k2, n))
    return td.BatchDraws([torch.stack(x) for x in zip(*lattices)], td.CloudDraws(*map(torch.stack, zip(*clouds))))


@pytest.mark.parametrize("cells", [22, 64, 202])
def test_terrain_from_jax_draws_matches_bits(cells):
    jax, jnp, jd = _jax()
    key = jax.random.PRNGKey(7 + cells)
    want = np.asarray(jd.procedural_terrain(key, cells, RES))
    got = td.terrain_from_draws(_jax_terrain_lattices(jax, key, cells), cells).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("sensor", [(0.0, 0.0, 0.8), (0.6, -0.3, 1.2)])
def test_cloud_from_jax_draws_matches_bits(sensor):
    """simulate_depth_cloud's footprint, clipping, terrain lookup and noise
    from JAX's draws: points and translation bit for bit."""
    jax, jnp, jd = _jax()
    cells, n = 202, 20000
    key = jax.random.PRNGKey(11)
    terrain = jd.procedural_terrain(jax.random.PRNGKey(5), cells, RES)
    pos = jnp.asarray(sensor, jnp.float32)
    want_pts, want_t = jd.simulate_depth_cloud(key, terrain, RES, pos, n)
    got_pts, got_t = td.cloud_from_draws(_t(terrain), RES, _t(pos), _jax_cloud_draws(jax, key, n))
    np.testing.assert_array_equal(_bits(got_pts.numpy()), _bits(want_pts))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_batch_clouds_from_jax_draws_match_jax():
    """make_batch_clouds' deterministic half on JAX's draws: every map's
    sensor translation and x, y bit for bit; terrain and z within 2 ulps
    (JAX jits and vmaps the batch, and XLA then contracts the value noise's
    interpolation into FMAs; eagerly the terrain is equal bit for bit,
    test_terrain_from_jax_draws_matches_bits)."""
    jax, jnp, jd = _jax()
    B, cells, n = 3, 64, 3000
    key = jax.random.PRNGKey(21)
    want_pts, want_t, want_terrain = (np.asarray(x) for x in jd.make_batch_clouds(key, B, cells, RES, n))
    draws = _jax_batch_draws(jax, key, B, cells, n)
    pts, t, terrain = (x.numpy() for x in td.batch_clouds_from_draws(draws, cells, RES))
    np.testing.assert_array_equal(_bits(t), _bits(want_t))
    np.testing.assert_array_equal(_bits(pts[..., :2]), _bits(want_pts[..., :2]))
    np.testing.assert_allclose(terrain, want_terrain, rtol=0, atol=1.2e-7)
    np.testing.assert_allclose(pts[..., 2], want_pts[..., 2], rtol=0, atol=2.4e-7)


def test_make_batch_clouds_shapes_and_statistics():
    """Per map: a terrain in the JAX function's range, points inside the
    map and the field of view's footprint around the sensor, on the terrain
    within 5 mm noise, the sensor at make_batch_clouds' position."""
    B, cells, n = 3, 64, 4000
    gen = td.make_generator(0, device="cpu")
    pts, t, terrain = td.make_batch_clouds(gen, B, cells, RES, n)
    assert pts.shape == (B, n, 3) and t.shape == (B, 3) and terrain.shape == (B, cells, cells)
    assert pts.dtype == t.dtype == terrain.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.tile(td.SENSOR_POS, (B, 1)).astype(np.float32))
    # octaves 0.15 + 0.075 + 0.0375 and terraces of 0.25 up to round(2 * 1)
    assert float(terrain.abs().max()) <= 0.2625 + 0.5 + 1e-6
    assert not torch.equal(terrain[0], terrain[1])
    world = pts + t[:, None, :]
    half = cells * RES / 2
    assert float(world[..., :2].min()) >= -half and float(world[..., :2].max()) < half
    r_max = 0.8 * math.tan(math.radians(42.5)) + 1.0
    r = torch.linalg.norm(world[..., :2] - t[:, None, :2], dim=-1)
    assert float(r.max()) <= r_max + 1e-5
    ix = ((world[..., 0] + half) / RES).long().clamp(0, cells - 1)
    iy = ((world[..., 1] + half) / RES).long().clamp(0, cells - 1)
    ground = torch.stack([terrain[b][ix[b], iy[b]] for b in range(B)])
    noise = (world[..., 2] - ground) / 0.005
    assert abs(float(noise.mean())) < 0.1 and abs(float(noise.std()) - 1.0) < 0.05


def test_draws_statistics_and_seeding():
    gen = td.make_generator(3, device="cpu")
    d = td.draw_cloud(gen, 20000, (2,))
    assert all(x.shape == (2, 20000) for x in d)
    np.testing.assert_allclose((d.cos_az**2 + d.sin_az**2).numpy(), 1.0, atol=1e-6)
    assert 0.0 <= float(d.radius_u.min()) and float(d.radius_u.max()) < 1.0
    assert abs(float(d.radius_u.mean()) - 0.5) < 0.01 and abs(float(d.noise.std()) - 1.0) < 0.02
    assert abs(float(d.cos_az.mean())) < 0.02 and abs(float(d.sin_az.mean())) < 0.02
    lats = td.draw_terrain(gen, 64, (2,))
    assert [tuple(x.shape) for x in lats] == [(2, *s) for s in td.terrain_lattice_shapes(64)]
    assert all(-1.0 <= float(x.min()) and float(x.max()) < 1.0 for x in lats)
    # the same seed gives the same clouds; another seed others
    a = td.make_batch_clouds(td.make_generator(9, "cpu"), 2, 32, RES, 500)
    b = td.make_batch_clouds(td.make_generator(9, "cpu"), 2, 32, RES, 500)
    c = td.make_batch_clouds(td.make_generator(10, "cpu"), 2, 32, RES, 500)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert td.make_generator(0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            td.make_generator(0)
