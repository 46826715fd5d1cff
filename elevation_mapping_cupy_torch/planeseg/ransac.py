"""Host-side RANSAC plane refinement.

Deterministic (fixed-seed) replacement for the reference's CGAL
Efficient_RANSAC wrapper (RansacPlaneExtractor.cpp; seeded at
SlidingWindowPlaneExtractor.cpp:221-224). Labels whose global plane fit
fails are re-segmented into multiple planes here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

__all__ = ["RansacParams", "detect_planes"]


@dataclasses.dataclass(frozen=True)
class RansacParams:
    """Mirrors RansacPlaneExtractorParameters defaults."""

    probability: float = 0.001
    min_points: int = 4
    epsilon: float = 0.025          # max point-plane distance
    cluster_epsilon: float = 0.08   # (not used by this sampler)
    normal_threshold_deg: float = 25.0
    max_iterations: int = 200


def detect_planes(
    points: np.ndarray,       # (N, 3)
    normals: np.ndarray,      # (N, 3)
    params: RansacParams = RansacParams(),
    seed: int = 0,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Greedy RANSAC: repeatedly fit the best-supported plane, remove inliers.

    Returns list of (normal (3,), support (3,), member_indices).
    """
    rng = np.random.default_rng(seed)
    cos_thresh = np.cos(np.radians(params.normal_threshold_deg))
    remaining = np.arange(len(points))
    out = []
    while len(remaining) >= max(params.min_points, 3):
        pts = points[remaining]
        nrm = normals[remaining]
        # Evaluate ALL K candidate hypotheses at once on a point SUBSAMPLE
        # (ranking planes needs only a sample of the support), then test the
        # single winner against every point. The original K-iteration loop
        # over all N points cost ~200 ms per refined label at 20k member
        # cells; this is ~2 ms. Same greedy structure; the ranking is
        # sample-based, so if the sample-ranked winner fails min_points a
        # full-point re-rank runs before giving up (see below).
        if params.max_iterations <= 0:
            break
        nn = np.linalg.norm(nrm, axis=1)
        cand = rng.integers(0, len(pts), size=params.max_iterations)
        n0 = nrm[cand] / np.maximum(nn[cand][:, None], 1e-9)     # (K, 3)
        off = np.einsum("kj,kj->k", pts[cand], n0)               # (K,)

        def rank(hyp: np.ndarray, n_sub: int) -> np.ndarray:
            """Inlier count per hypothesis on a point subsample."""
            if len(pts) > n_sub:
                sub = rng.permutation(len(pts))[:n_sub]
                spts, snrm, snn = pts[sub], nrm[sub], nn[sub]
            else:
                spts, snrm, snn = pts, nrm, nn
            dist = np.abs(spts @ n0[hyp].T - off[hyp][None, :])
            ndot = np.abs(snrm @ n0[hyp].T) / np.maximum(snn[:, None], 1e-9)
            inl = (dist < params.epsilon) & (ndot > cos_thresh)
            inl[:, nn[cand[hyp]] <= 1e-9] = False                # degenerate seeds
            return inl.sum(axis=0)

        # two-stage ranking: all K hypotheses on 512 points, top 16 on 8192
        hyp = np.arange(len(cand))
        coarse = rank(hyp, 512)
        top = hyp[np.argsort(-coarse)[:16]]
        fine = rank(top, 8192)
        best_i = int(np.argmax(fine))
        # near-tied winners get a full-support re-rank: the sampled count
        # carries ~sqrt(c) noise, so two close planes could swap places on
        # the full set (keeps the old full-evaluation winner deterministic)
        noise = 3.0 * np.sqrt(max(float(fine[best_i]), 1.0)) + 1.0
        tied = top[fine >= fine[best_i] - noise]
        if len(pts) > 8192 and len(tied) > 1:
            best = int(tied[np.argmax(rank(tied, len(pts)))])
        else:
            best = int(top[best_i])

        def full_inliers(b: int) -> np.ndarray:
            bd = np.abs(pts @ n0[b] - off[b])
            bn = np.abs(nrm @ n0[b]) / np.maximum(nn, 1e-9)
            ok = (bd < params.epsilon) & (bn > cos_thresh)
            return ok if nn[cand[b]] > 1e-9 else np.zeros_like(ok)

        best_inliers = full_inliers(best)
        if best_inliers.sum() < max(params.min_points, 3):
            # the sample-ranked winner can miss a small-support plane the
            # old full-point evaluation would have found: re-rank every
            # hypothesis on the full point set once before terminating
            # (one vectorized pass; runs only on the would-be last round)
            best = int(np.argmax(rank(hyp, len(pts))))
            best_inliers = full_inliers(best)
            if best_inliers.sum() < max(params.min_points, 3):
                break
        member = remaining[best_inliers]
        mp = points[member]
        mean = mp.mean(axis=0)
        cov = np.cov((mp - mean).T)
        w, v = np.linalg.eigh(cov)
        normal = v[:, 0]
        if normal[2] < 0:
            normal = -normal
        out.append((normal, mean, member))
        remaining = remaining[~best_inliers]
    return out
