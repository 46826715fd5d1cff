"""The reference's replays of a measured window, and the comparison.

``ServiceReplay`` follows a mapping service through the events a window
logged (pose updates, fused frames, the variance and time timers,
publishes) on the reference, starting from a fresh map, and works out
every input itself: the frames from their raw PointCloud2 bytes, the drift
gate's noise values from the poses by the service's low-pass filter.
``replay_episode`` steps a batch of fresh maps through one episode of the
datagen traffic. ``mismatch_share`` is the number the comparison reads.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from . import update as U
from .params import Params

__all__ = ["TOL", "mismatch_share", "ServiceReplay", "replay_episode", "state_mismatch"]

# a cell agrees when |program - reference| <= TOL * max(1, |reference|),
# or both are NaN: the last bits of a sum move with the order of the
# atomic adds, and a share of cells near a threshold flips
TOL = 1e-4


def mismatch_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of the cells of ``got`` that do not agree with ``want``."""
    got = torch.as_tensor(got).to(want.device, torch.float32)
    want = want.float()
    both_nan = torch.isnan(got) & torch.isnan(want)
    close = torch.abs(got - want) <= TOL * torch.clamp(torch.abs(want), min=1.0)
    return float((~(close | both_nan)).float().mean()) if want.numel() else 0.0


def state_mismatch(layers: torch.Tensor, normal: torch.Tensor, scalars: torch.Tensor, st: U.State, b: int) -> Dict[str, float]:
    """Mismatch share of every field of map ``b``: the seven layers, the
    three normals and the map's centre and drift numbers (``scalars``: the
    program's center, mean error and additive error, five values)."""
    names, want = U.layer_stack(st, b)
    got = torch.cat([layers, normal]).to(want.device)
    out = {nm: mismatch_share(got[i], want[i]) for i, nm in enumerate(names)}
    ref_scalars = torch.cat([st.center[b], st.mean_error[b, None], st.additive[b, None]])
    out["center_and_drift"] = mismatch_share(scalars, ref_scalars)
    return out


def _bucket(n: int) -> int:
    """The points of a frame padded to a power of two (at least 1024), as
    the upstream node pads them; padding carries no point."""
    return max(1024, 1 << int(math.ceil(math.log2(max(n, 1)))))


class ServiceReplay:
    """A mapping service's map, driven by logged events on the reference.

    ``frames``: per frame, (its raw records as an (N, F) float32 array
    whose first three fields are x, y, z, R, t), in the order the ring accepted them; ``poses``: per pose update,
    (position, R). ``alpha`` is the service's pose low-pass weight."""

    def __init__(self, p: Params, weights: U.Weights, alpha: float, device, storage=torch.float32):
        self.p, self.w, self.alpha, self.device, self.storage = p, weights, alpha, device, storage
        self.st = U.fresh(p, 1, device)
        self.lp_pos = np.zeros(3)
        self.lp_rot = np.eye(3)
        self.pos_noise = 0.0
        self.rot_noise = 0.0

    def pose(self, position: np.ndarray, R: np.ndarray) -> None:
        position = np.asarray(position, np.float64)
        R = np.asarray(R, np.float64)
        self.lp_pos = (1 - self.alpha) * self.lp_pos + self.alpha * position
        self.lp_rot = (1 - self.alpha) * self.lp_rot + self.alpha * R
        self.pos_noise = float(np.linalg.norm(position - self.lp_pos))
        self.rot_noise = float(np.linalg.norm(R - self.lp_rot))
        pos = torch.as_tensor(np.asarray(position, np.float32), device=self.device)
        self.st = U.move_to(self.st, pos[None], self.p, self.storage)

    def cloud(self, records: np.ndarray, R: np.ndarray, t: np.ndarray) -> None:
        xyz = np.asarray(records, np.float32)[:, :3]
        xyz = xyz[np.isfinite(xyz).all(axis=1)]
        m = _bucket(len(xyz))
        pts = np.zeros((m, 3), np.float32)
        pts[: len(xyz)] = xyz
        mask = np.zeros((m,), bool)
        mask[: len(xyz)] = True
        dev = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)[None]  # noqa: E731
        self.st = U.update(self.st, dev(pts), torch.from_numpy(mask).to(self.device)[None], dev(R), dev(t),
                           self.pos_noise, self.rot_noise, self.w, self.p, self.storage)

    def variance(self) -> None:
        self.st = U.update_variance(self.st, self.p, self.storage)

    def time(self) -> None:
        self.st = U.update_time(self.st, self.p, self.storage)

    def publish(self, layers: Sequence[str]) -> Dict[str, torch.Tensor]:
        return {nm: U.export(self.st, 0, nm, self.p) for nm in layers}

    def run(self, events: Iterable[Tuple], frames: Sequence, poses: Sequence, published: Sequence[Dict[str, np.ndarray]],
            layers: Sequence[str]) -> List[float]:
        """Replays ``events`` and returns, per publish, the largest
        mismatch share over its layers against what the program's
        publisher handed out."""
        shares = []
        for ev in events:
            kind = ev[0]
            if kind == "pose":
                self.pose(*poses[ev[1]])
            elif kind == "cloud":
                self.cloud(*frames[ev[1]])
            elif kind == "variance":
                self.variance()
            elif kind == "time":
                self.time()
            elif kind == "publish":
                want = self.publish(layers)
                got = published[ev[1]]
                if sorted(got) != sorted(layers):
                    shares.append(1.0)
                    continue
                shares.append(max(mismatch_share(torch.from_numpy(np.asarray(got[nm])), want[nm]) for nm in layers))
            else:
                raise ValueError(f"unknown event {ev!r}")
        return shares


@torch.no_grad()
def replay_episode(p: Params, weights: U.Weights, clouds: Sequence[torch.Tensor], base: Sequence[torch.Tensor],
                   sensor: Sequence[torch.Tensor], storage=torch.float32) -> U.State:
    """A fresh batch of maps through one episode: per step, the move to the
    robot's ``base`` (B, 3) and the update with the sensor's cloud (B, N, 3)
    in its own frame, its rotation the identity, at ``sensor`` (B, 3)."""
    b, n = clouds[0].shape[:2]
    dev = clouds[0].device
    st = U.fresh(p, b, dev)
    R = torch.eye(3, device=dev).expand(b, 3, 3)
    mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    zero = torch.zeros((b,), device=dev)
    for pts, pos, t in zip(clouds, base, sensor):
        st = U.move_to(st, pos, p, storage)
        st = U.update(st, pts, mask, R, t, zero, zero, weights, p, storage)
    return st
