"""The traffic generators give the same inputs for the same seed, other
inputs for another, and the same sizes and arrivals for every seed."""

import numpy as np
import pytest
import torch

from benchmark.tests.small import shrunk
from benchmark.traffic import lidar_scene, terrain_clouds


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**40 + 3])
def test_lidar_frames_are_deterministic_in_the_seed(seed):
    _, tr = shrunk("anymal_deployed.lidar_10hz")
    a, pa = lidar_scene.make_frames(seed, 3, tr, "cpu")
    b, pb = lidar_scene.make_frames(seed, lidar_scene.CHUNK + 2, tr, "cpu")
    c, _ = lidar_scene.make_frames(seed + 1, 3, tr, "cpu")
    assert a.shape == (3, tr["points"], tr["point_step"] // 4)
    np.testing.assert_array_equal(a, b[:3])
    assert not np.array_equal(np.nan_to_num(a), np.nan_to_num(c))
    for (r1, t1, p1), (r2, t2, p2) in zip(pa, pb):
        np.testing.assert_array_equal(t1, t2)
    share = np.isnan(a[..., :3]).any(-1).mean()
    assert 0.002 < share < 0.03


def test_lidar_poses_follow_the_arc():
    _, tr = shrunk("anymal_deployed.lidar_10hz")
    R, t, pos = lidar_scene.robot_pose(10, tr["path"])
    np.testing.assert_allclose(pos, [0.3, 0.12, 0.0], atol=1e-6)
    np.testing.assert_allclose(t[2], 0.7)
    np.testing.assert_allclose(R[0, 0], np.cos(np.radians(20.0)), atol=1e-6)


@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_episodes_are_deterministic_in_the_seed(seed):
    _, tr = shrunk("datagen_default.b8_ep8")
    a = terrain_clouds.make_pool(seed, tr, 52, 0.04, "cpu")
    b = terrain_clouds.make_pool(seed, tr, 52, 0.04, "cpu")
    c = terrain_clouds.make_pool(seed + 1, tr, 52, 0.04, "cpu")
    assert len(a) == tr["pool_episodes"] and len(a[0].clouds) == tr["episode_steps"]
    assert a[0].clouds[0].shape == (tr["maps"], tr["points"], 3)
    for x, y in zip(a, b):
        for cx, cy in zip(x.clouds, y.clouds):
            assert torch.equal(cx, cy)
    assert not torch.equal(a[0].clouds[0], c[0].clouds[0])
    step = a[0].base[1] - a[0].base[0]
    assert torch.allclose(step, torch.tensor([tr["advance_m"], 0.0, 0.0]).expand_as(step))
