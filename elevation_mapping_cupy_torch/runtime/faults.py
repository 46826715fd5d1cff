"""Fault injection for robustness testing (noiseNode.cpp equivalent).

The reference ships a test node that republishes elevation maps with additive
noise; here the injectors wrap sensor frames / map layers for the same kind
of downstream-robustness experiments, plus sensor dropout modes the reference
ROS stack exhibits in practice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["add_map_noise", "corrupt_cloud", "drop_frames"]


def add_map_noise(layer: np.ndarray, sigma: float = 0.02, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return layer + rng.normal(0, sigma, layer.shape).astype(layer.dtype)


def corrupt_cloud(points: np.ndarray, nan_frac: float = 0.05,
                  outlier_frac: float = 0.01, outlier_mag: float = 5.0,
                  seed: int = 0) -> np.ndarray:
    """Inject NaN dropouts and gross outliers into a pointcloud."""
    rng = np.random.default_rng(seed)
    out = points.copy()
    n = len(out)
    k = int(n * nan_frac)
    if k:
        out[rng.choice(n, k, replace=False), :3] = np.nan
    m = int(n * outlier_frac)
    if m:
        idx = rng.choice(n, m, replace=False)
        out[idx, 2] += rng.normal(0, outlier_mag, m)
    return out


def drop_frames(frames, drop_every: int = 3):
    """Simulate frame drops in a sensor stream."""
    return [f for i, f in enumerate(frames) if (i + 1) % drop_every != 0]
