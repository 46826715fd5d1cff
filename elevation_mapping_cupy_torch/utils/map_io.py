"""Map ↔ image persistence (SaveElevationMapAsImageNode / LoadGridmapFromImage
equivalents, plane_segmentation/convex_plane_decomposition_ros +
LoadGridmapFromImage.cpp:14-35)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["save_layer_as_image", "load_heightmap_from_image"]


def save_layer_as_image(layer: np.ndarray, path: str,
                        vmin: Optional[float] = None, vmax: Optional[float] = None) -> Tuple[float, float]:
    """Normalize a layer to uint8 and write a PNG (or .npy fallback).
    Returns (vmin, vmax) used, needed to reload heights losslessly-ish."""
    arr = np.asarray(layer, np.float32)
    finite = arr[np.isfinite(arr)]
    lo = float(vmin if vmin is not None else (finite.min() if finite.size else 0.0))
    hi = float(vmax if vmax is not None else (finite.max() if finite.size else 1.0))
    scale = (hi - lo) or 1.0
    img = np.clip((arr - lo) / scale, 0, 1)
    img = np.where(np.isfinite(arr), img, 0.0)
    u8 = (img * 255).astype(np.uint8)
    written = False
    try:
        import cv2 as cv

        # imwrite signals failure (bad directory, unsupported ext) by
        # returning False rather than raising
        written = bool(cv.imwrite(path, u8))
    except Exception:
        written = False
    if not written:
        np.save(path + ".npy", u8)
    return lo, hi


def load_heightmap_from_image(path: str, height_scale: float = 1.0,
                              offset: float = 0.0) -> np.ndarray:
    """PNG → height map: uint8 [0,255] → [offset, offset+height_scale]."""
    import os

    img = None
    try:
        import cv2 as cv

        img = cv.imread(path, cv.IMREAD_GRAYSCALE)  # None on missing/corrupt
    except ImportError:
        pass
    if img is None:
        if os.path.exists(path + ".npy"):
            img = np.load(path + ".npy")
        else:
            raise FileNotFoundError(f"{path} (and no {path}.npy fallback)")
    return img.astype(np.float32) / 255.0 * height_scale + offset
