"""Log replay: re-run recorded sensor sequences through the engine.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/runtime/replay.py`` (a
copy of ``LogWriter``, ``read_log`` and ``replay`` over the port's
``ElevationMap``; the log schema is the same, so a log written by either
package replays in both). A log is an .npz of per-frame point clouds and
poses; replaying drives the mapper as the live runtime does and returns
per-frame layer snapshots for comparison against reference outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import MapConfig
from ..mapper import ElevationMap

__all__ = ["LogWriter", "read_log", "replay"]


class LogWriter:
    """Accumulates frames and writes a single .npz log."""

    def __init__(self, channels: Sequence[str] = ("x", "y", "z")):
        self.channels = list(channels)
        self.frames: List[Dict[str, np.ndarray]] = []

    def add(self, points: np.ndarray, R: np.ndarray, t: np.ndarray,
            position: Optional[np.ndarray] = None, stamp: float = 0.0) -> None:
        self.frames.append(
            dict(points=np.asarray(points, np.float32),
                 R=np.asarray(R, np.float32),
                 t=np.asarray(t, np.float32),
                 position=np.asarray(position if position is not None else t, np.float32),
                 stamp=np.float64(stamp))
        )

    def save(self, path: str) -> None:
        arrays = {"n_frames": np.int64(len(self.frames)),
                  "channels": np.array(self.channels, dtype=object)}
        for i, f in enumerate(self.frames):
            for k, v in f.items():
                arrays[f"f{i}_{k}"] = v
        np.savez_compressed(path, **arrays)


def read_log(path: str) -> Iterator[Dict[str, np.ndarray]]:
    with np.load(path, allow_pickle=True) as z:
        n = int(z["n_frames"])
        channels = list(z["channels"].tolist())
        for i in range(n):
            yield dict(
                points=z[f"f{i}_points"],
                R=z[f"f{i}_R"],
                t=z[f"f{i}_t"],
                position=z[f"f{i}_position"],
                stamp=float(z[f"f{i}_stamp"]),
                channels=channels,
            )


def replay(
    path: str,
    cfg: MapConfig,
    snapshot_layers: Sequence[str] = ("elevation", "traversability"),
    move_with_pose: bool = True,
    mapper: Optional[ElevationMap] = None,
    raycast_mode: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> List[Dict[str, np.ndarray]]:
    """Run a log through the engine on ``device``; returns per-frame layer
    snapshots (host NumPy, cropped and flipped like the GridMap export).

    ``raycast_mode`` overrides ``cfg.raycast_mode`` ("exact" for
    reference-parity replays, "polar" for the production path). A given
    ``mapper`` keeps its own config and device."""
    if raycast_mode is not None:
        if mapper is not None:
            raise ValueError("pass raycast_mode via the mapper's cfg when supplying a mapper")
        cfg = dataclasses.replace(cfg, raycast_mode=raycast_mode)
    em = mapper or ElevationMap(cfg, device=device)
    out = []
    for frame in read_log(path):
        if move_with_pose:
            em.move_to(frame["position"], frame["R"])
        em.input_pointcloud(frame["points"], frame["channels"], frame["R"], frame["t"], 0.0, 0.0)
        em.update_variance()
        em.update_time()
        out.append(em.get_layers(snapshot_layers))
    return out
