"""Batched multi-environment datagen on one device.

Port of ``examples/batched_datagen.py``: B independent robot-centric maps
updated per step from simulated sensors over procedural terrains, every
stage of the update run once for the whole batch (``parallel.batched_update``).
Reports maps/s.

    python -m elevation_mapping_cupy_torch.examples.batched_datagen [--device cpu]

with ``--batch`` maps (32) of ``--points`` points (20000) for ``--steps``
steps (5).

Each step's terrains and clouds come from ``runtime.datagen``'s
``make_batch_clouds`` in its two halves: the draws from one seeded
generator on the device (``draw_batch_clouds``) and the work on them
(``batch_clouds_from_draws``). ``run(draws=...)`` takes other draws, one
``BatchDraws`` a step (the tests pass the JAX example's).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import torch

from ..config import MapConfig
from ..nn.traversability import default_weights
from ..parallel.batch import batched_update, init_batch
from ..runtime import datagen
from . import add_device_argument, resolve, sync


def config(points: int) -> MapConfig:
    return MapConfig(resolution=0.08, map_length=6.0, max_ray_length=1.0, max_points=points)


def run(device=None, batch: int = 32, points: int = 20_000, steps: int = 5, seed: int = 0, draws=None) -> dict:
    """``steps`` batched updates of ``batch`` maps; returns each step's
    seconds (the first includes the first use of every stage), the
    steady-state maps/s and the final states."""
    dev = resolve(device)
    cfg = config(points)
    w = default_weights().to(dev)
    states = init_batch(cfg, batch, dev)
    gen = datagen.make_generator(seed, dev)
    zeros = torch.zeros(batch, device=dev)
    Rs = torch.eye(3, device=dev).expand(batch, 3, 3).contiguous()
    mask = torch.ones(batch, points, dtype=torch.bool, device=dev)
    seconds = []
    for step in range(steps):
        d = datagen.draw_batch_clouds(gen, batch, cfg.cell_n, points) if draws is None else draws[step]
        pts, t, _ = datagen.batch_clouds_from_draws(d, cfg.cell_n, cfg.resolution)
        sync(dev)
        t0 = time.perf_counter()
        states = batched_update(states, pts, mask, Rs, t, zeros, zeros, w, cfg)
        sync(dev)
        seconds.append(time.perf_counter() - t0)
    steady = batch * (steps - 1) / sum(seconds[1:]) if steps > 1 else None
    return {"cfg": cfg, "devices": 1, "seconds": seconds, "maps_per_s": steady, "states": states}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m elevation_mapping_cupy_torch.examples.batched_datagen",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--points", type=int, default=20_000)
    ap.add_argument("--steps", type=int, default=5)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    r = run(args.device, args.batch, args.points, args.steps)
    cfg, B = r["cfg"], args.batch
    print(f"devices={r['devices']}  envs={B}  cells={cfg.cell_n}^2  pts/env={args.points}")
    for step, dt in enumerate(r["seconds"]):
        print(f"step {step}: {dt*1e3:8.1f} ms  ({B/dt:8.1f} maps/s)")
    if r["maps_per_s"] is not None:
        print(f"steady-state: {r['maps_per_s']:.1f} maps/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
