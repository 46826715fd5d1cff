"""Cells of the benchmark cut to a size the CPU runs in seconds: a 52x52
map, 3 m rays, 4096 points a cloud, 5 frames a second, batches of 2 maps
with episodes of 3 steps. Only the tests use these sizes."""

import copy
import time

from benchmark import harness as H
from benchmark import run as RUN

CELLS = ("anymal_deployed.lidar_10hz", "datagen_default.b64_ep8", "datagen_default.b8_ep8")


def shrunk(name: str):
    """(config, traffic) of a cell at the tests' size."""
    man = H.manifest()
    cell = H.workload(man, name)
    cfg = copy.deepcopy(H.config_file(man, cell["config"]))
    tr = copy.deepcopy(H.traffic_file(cell["traffic"]))
    cfg["map_config"]["map_length"] = 2.0
    cfg["map_config"]["max_ray_length"] = min(cfg["map_config"]["max_ray_length"], 3.0)
    tr["points"] = 4096
    if tr["driver"] == "batched_steps":
        tr.update(maps=2, pool_episodes=2, episode_steps=3)
    else:
        tr["scene"]["r_max"] = 2.0
        tr["rate_hz"] = 5.0
        tr["warmup_frames"] = 1
    return cfg, tr


def context(name: str, seed: int, seconds: float = 1.0, trace: bool = False):
    cfg, tr = shrunk(name)
    return RUN.context(name, seed, seconds, trace, "cpu", time.perf_counter(), None, cfg, tr)
