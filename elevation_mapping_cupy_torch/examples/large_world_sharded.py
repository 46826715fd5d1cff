"""City-block-scale mapping: ONE large world map sharded over processes.

Port of ``examples/large_world_sharded.py``. The reference caps the world
at a robot-centric 8 m window because one GPU holds one map
(elevation_mapping.py:200-215). Here a 512-cell (51 m @ 0.1 m) world runs
as a single map whose rows are cut over a ``torch.distributed`` world of
processes (``parallel.spatial``):

  * each process holds a block of rows and steps it with a ghost zone of
    ``ghost_width(cfg)`` rows from its neighbours, so every stencil and the
    traversability CNN see the cells they read,
  * the point scatters are shard-local: each process bins the points that
    fall in its padded block and runs K1 on that block alone,
  * a robot drives a loop through the world; every frame fuses a local
    LiDAR scan into the shared world map.

    python -m elevation_mapping_cupy_torch.examples.large_world_sharded [--world 8] [--backend gloo|nccl] [--device cpu]

The script starts the world's processes itself (on localhost, a free
port) and waits for them. ``--backend`` defaults to NCCL when every
process has a card of its own and to gloo otherwise: NCCL takes one rank a
card, so processes that share one card (or the CPU) carry their halos
through host memory over gloo.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import MapConfig
from . import add_device_argument, resolve, sync

MODULE = "elevation_mapping_cupy_torch.examples.large_world_sharded"
# cell_n = round(51.0/0.1)+2 = 512: divisible by a world of 8
CONFIG = MapConfig(resolution=0.1, map_length=51.0, max_ray_length=1.0, max_points=20000)
WORLD = 8
FRAMES = 12
SENSOR_T = np.array([0.0, 0.0, 1.5], np.float32)
TIMEOUT_S = 600


def world_height(x, y):
    """Streets + two raised 'building' slabs."""
    h = 0.02 * np.sin(0.4 * x) * np.cos(0.3 * y)
    h = np.where((np.abs(x - 8) < 4) & (np.abs(y - 6) < 3), 1.2, h)
    h = np.where((np.abs(x + 10) < 5) & (np.abs(y + 8) < 4), 0.8, h)
    return h.astype(np.float32)


def clouds(frames: int = FRAMES) -> List[np.ndarray]:
    """The first ``frames`` scans of the robot's loop of FRAMES waypoints:
    each a 12 m square around the robot, in the sensor frame (z = 1.5)."""
    rng = np.random.default_rng(0)
    n = CONFIG.max_points
    waypoints = [(r * np.cos(a), r * np.sin(a))
                 for r, a in zip(np.linspace(4, 18, FRAMES), np.linspace(0, 2 * np.pi, FRAMES, endpoint=False))]
    out = []
    for wx, wy in waypoints[:frames]:
        px = rng.uniform(wx - 6, wx + 6, n).astype(np.float32)
        py = rng.uniform(wy - 6, wy + 6, n).astype(np.float32)
        wz = world_height(px, py) + rng.normal(0, 0.01, n).astype(np.float32)
        out.append(np.stack([px, py, wz - SENSOR_T[2]], -1))
    return out


def default_backend(device: torch.device, world: int) -> str:
    """NCCL when each process can have a card of its own, else gloo."""
    return "nccl" if device.type == "cuda" and torch.cuda.device_count() >= world else "gloo"


def worker(port: int, rank: int, size: int, folder: str, device: str, backend: str, frames: int) -> None:
    """One process of the world: its block of the map through every
    frame, each step timed from a barrier to a synchronise; then the whole
    map gathered. Writes ``rank{rank}.json`` (step seconds, block shape) and,
    on rank 0, ``world.npz`` (the gathered layers and normals) to
    ``folder``."""
    import torch.distributed as tdist

    from ..nn.traversability import default_weights
    from ..parallel import distributed, make_mesh, spatial
    from ..state import init_state

    if device == "cpu":
        # the world's processes share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // size))
    if not distributed.initialize(f"localhost:{port}", size, rank, device="cpu" if backend == "gloo" else "cuda"):
        raise RuntimeError("no process group")
    try:
        dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device(device)
        cfg = CONFIG
        mesh = make_mesh((size,), ("x",))
        w = default_weights().to(dev)
        step = spatial.spatial_update_pointcloud(mesh, cfg, "x")
        state = spatial.shard_state_spatial(init_state(cfg, dev), mesh, "x")
        mask = torch.ones(cfg.max_points, dtype=torch.bool, device=dev)
        R = torch.eye(3, device=dev)
        t = torch.from_numpy(SENSOR_T).to(dev)
        seconds = []
        for pts in clouds(frames):
            pts = torch.from_numpy(pts).to(dev)
            sync(dev)
            tdist.barrier()
            t0 = time.perf_counter()
            state = step(state, pts, mask, R, t, 0.0, 0.0, w)
            sync(dev)
            seconds.append(time.perf_counter() - t0)
        block = list(state.layers.shape[-2:])
        whole = spatial.gather_spatial(state, mesh, "x")
        with open(os.path.join(folder, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "step_s": seconds, "block": block, "device": str(dev)}, f)
        if rank == 0:
            np.savez(os.path.join(folder, "world.npz"), layers=whole.layers.cpu().numpy(),
                     normal=whole.normal.cpu().numpy())
    finally:
        distributed.shutdown()


def parse_worker(argv: Sequence[str]) -> dict:
    """The keyword arguments of :func:`worker` from a worker's command line
    (``--worker PORT RANK SIZE DIR --device D --backend B --frames F``)."""
    ap = argparse.ArgumentParser(prog=f"python -m {MODULE} --worker")
    ap.add_argument("--worker", nargs=4, required=True, metavar=("PORT", "RANK", "SIZE", "DIR"))
    ap.add_argument("--device", required=True)
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--frames", type=int, required=True)
    a = ap.parse_args(argv)
    port, rank, size, folder = a.worker
    return {"port": int(port), "rank": int(rank), "size": int(size), "folder": folder, "device": a.device,
            "backend": a.backend, "frames": a.frames}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(world: int, device: torch.device, backend: str, frames: int,
           worker_argv: Optional[Sequence[str]] = None) -> str:
    """Start the world's ``world`` processes and wait for them; a process
    that fails, or a world that outlasts TIMEOUT_S, raises (every process is
    stopped first). ``worker_argv`` starts one worker (default:
    this module under the current interpreter); the worker's arguments are
    appended. Returns the folder the workers wrote to."""
    folder = tempfile.mkdtemp(prefix=f"large_world{world}_")
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    base = list(worker_argv or [sys.executable, "-m", MODULE])
    procs = [
        subprocess.Popen(base + ["--worker", str(port), str(rank), str(world), folder, "--device", device.type,
                                 "--backend", backend, "--frames", str(frames)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for rank in range(world)
    ]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            shutil.rmtree(folder, ignore_errors=True)
            raise RuntimeError(f"world of {world}: rank {rank} exited {p.returncode}:\n{text[-6000:]}")
    return folder


def run(device=None, world: int = WORLD, backend: Optional[str] = None, frames: int = FRAMES,
        worker_argv: Optional[Sequence[str]] = None) -> dict:
    """The world map through ``frames`` frames in a world of ``world``
    processes. Returns the gathered layers and normals (rank 0's), each
    rank's step seconds and block, and the world's wall seconds."""
    dev = resolve(device)
    cfg = CONFIG
    if cfg.cell_n % world:
        raise ValueError(f"{cfg.cell_n} rows do not split over {world} processes")
    backend = backend or default_backend(dev, world)
    if backend == "nccl" and (dev.type != "cuda" or torch.cuda.device_count() < world):
        raise ValueError(f"NCCL takes one card a process: {world} processes, "
                         f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} cards; use --backend gloo")
    t0 = time.perf_counter()
    folder = launch(world, dev, backend, frames, worker_argv)
    seconds = time.perf_counter() - t0
    try:
        reports = []
        for rank in range(world):
            with open(os.path.join(folder, f"rank{rank}.json")) as f:
                reports.append(json.load(f))
        with np.load(os.path.join(folder, "world.npz")) as z:
            layers, normal = z["layers"], z["normal"]
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    # every process held its own rows of the map
    blocks = [r["block"] for r in reports]
    if blocks != [[cfg.cell_n // world, cfg.cell_n]] * world:
        raise AssertionError(f"blocks {blocks} are not {world} row blocks of the {cfg.cell_n}-cell map")
    return {"cfg": cfg, "world": world, "backend": backend, "frames": frames, "layers": layers, "normal": normal,
            "reports": reports, "seconds": seconds}


def summary(layers: np.ndarray) -> dict:
    """What the example prints of a gathered map: the valid share, the
    height range and building A's mean height."""
    cfg = CONFIG
    valid = layers[2] > 0.5
    elev = np.where(valid, layers[0], np.nan)
    cn = cfg.cell_n
    # the slab tops are mapped at their true heights
    i, j = int(cn / 2 + 8.0 / cfg.resolution), int(cn / 2 + 6.0 / cfg.resolution)
    return {"coverage": float(valid.mean()), "min": float(np.nanmin(elev)), "max": float(np.nanmax(elev)),
            "building_a": float(np.nanmean(elev[i - 3:i + 3, j - 3:j + 3]))}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--worker" in argv:
        worker(**parse_worker(argv))
        return 0
    ap = argparse.ArgumentParser(prog=f"python -m {MODULE}", description=__doc__.split("\n\n")[0])
    add_device_argument(ap)
    ap.add_argument("--world", type=int, default=WORLD, help="processes the map's rows are cut over")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl with a card for every process, else gloo")
    ap.add_argument("--frames", type=int, default=FRAMES)
    args = ap.parse_args(argv)
    r = run(args.device, args.world, args.backend, args.frames)
    cfg = r["cfg"]
    print(f"world: {cfg.cell_n}x{cfg.cell_n} cells "
          f"({cfg.map_length:.0f} m @ {cfg.resolution} m) over {r['world']} shards")
    s = summary(r["layers"])
    print(f"world coverage after {r['frames']} frames: {100 * s['coverage']:.1f}% of {cfg.cell_n ** 2} cells")
    print(f"height range: [{s['min']:.2f}, {s['max']:.2f}] m (buildings at 0.8 / 1.2 m)")
    print(f"building A top: {s['building_a']:.2f} m (true 1.20)")
    print("sharded world map ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
