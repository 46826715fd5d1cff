"""The plain reference agrees with the program on the CPU, where both take
the same plain scatter: bit for bit on single updates, and on whole shrunk
windows of every cell as the runs judge them."""

import numpy as np
import pytest
import torch

from benchmark import harness as H
from benchmark.reference import update as U
from benchmark.reference.params import Params
from benchmark.tests.small import CELLS, context, shrunk
from benchmark.traffic import lidar_scene, terrain_clouds


def test_params_derive_the_program_sizes():
    from elevation_mapping_cupy_torch import MapConfig
    from elevation_mapping_cupy_torch.ops.raycast import resolve_raycast_mode

    for name in ("anymal_deployed", "datagen_default"):
        body = H.config_file(H.manifest(), name)
        p, cfg = Params(body["map_config"]), MapConfig(**H.map_config_fields(body))
        assert (p.cell_n, p.n_ray_steps, p.azimuth_bins, p.overlap_cell_range) == (
            cfg.cell_n, cfg.n_ray_steps, cfg.azimuth_bins, cfg.overlap_cell_range)
        assert p.cleanup_mode() == resolve_raycast_mode(cfg) == "polar"


def test_single_updates_and_moves_equal_the_program_bit_for_bit():
    from elevation_mapping_cupy_torch import MapConfig, core, init_state
    from elevation_mapping_cupy_torch.nn.traversability import TravFilter

    cfg_d, tr = shrunk("anymal_deployed.lidar_10hz")
    cfg = MapConfig(**H.map_config_fields(cfg_d))
    p = Params(cfg_d["map_config"])
    arrays = H.weight_arrays(cfg_d)
    trav, w = TravFilter(**arrays), U.Weights.from_arrays(arrays, "cpu")
    records, poses = lidar_scene.make_frames(11, 4, tr, "cpu")
    st, ref = init_state(cfg, "cpu"), U.fresh(p, 1, "cpu")
    for k in range(4):
        R, t, pos = (torch.from_numpy(x) for x in poses[k])
        st = core.move_to(st, pos, R, cfg)
        ref = U.move_to(ref, pos[None], p)
        xyz = torch.from_numpy(np.nan_to_num(records[k][:, :3]))
        mask = torch.from_numpy(np.isfinite(records[k][:, :3]).all(1))
        st = core.update_pointcloud(st, xyz, mask, R, t, 0.05, 0.02, trav, cfg)
        ref = U.update(ref, xyz[None], mask[None], R[None], t[None], 0.05, 0.02, w, p)
        st = core.update_variance(st, cfg)
        ref = U.update_variance(ref, p)
    assert torch.equal(st.layers, ref.layers[0])
    assert torch.equal(st.normal, ref.normal[0])
    assert torch.equal(st.center, ref.center[0])
    assert torch.equal(st.additive_mean_error, ref.additive[0])
    assert float((st.layers[2] > 0.5).float().mean()) > 0.2


def test_a_batch_of_two_equals_the_program_bit_for_bit():
    from elevation_mapping_cupy_torch import MapConfig
    from elevation_mapping_cupy_torch.nn.traversability import TravFilter
    from elevation_mapping_cupy_torch.parallel import batched_move_to, batched_update, init_batch

    cfg_d, tr = shrunk("datagen_default.b64_ep8")
    cfg = MapConfig(**H.map_config_fields(cfg_d))
    p = Params(cfg_d["map_config"])
    arrays = H.weight_arrays(cfg_d)
    ep = terrain_clouds.make_pool(3, tr, cfg.cell_n, cfg.resolution, "cpu")[0]
    b = tr["maps"]
    eye = torch.eye(3).expand(b, 3, 3)
    zero = torch.zeros(b)
    st = init_batch(cfg, b, "cpu")
    for s in range(tr["episode_steps"]):
        st = batched_move_to(st, ep.base[s], eye, cfg)
        st = batched_update(st, ep.clouds[s], torch.ones(ep.clouds[s].shape[:2], dtype=torch.bool), eye,
                            ep.sensor[s], zero, zero, TravFilter(**arrays), cfg)
    from benchmark.reference.replay import replay_episode

    ref = replay_episode(p, U.Weights.from_arrays(arrays, "cpu"), ep.clouds, ep.base, ep.sensor)
    assert torch.equal(st.layers, ref.layers) and torch.equal(st.normal, ref.normal)
    assert torch.equal(st.center, ref.center)


@pytest.mark.parametrize("name", CELLS)
def test_a_shrunk_window_of_each_cell_agrees(name):
    from benchmark import run as RUN

    ctx = context(name, 2**31 + 11, seconds=1.0)
    correct, rec, metrics, checks, _ = RUN.execute(ctx)
    assert correct and all(c["value"] == 0.0 for c in checks.values()), checks
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert set(metrics) == {m["name"] for m in H.cell_metrics(H.manifest(), name)[0]}
