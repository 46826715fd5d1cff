"""Plane decomposition (convex plane segmentation) on the port's device:
preprocessing, extraction and postprocessing as PyTorch, contours, RANSAC
and drawing on the host."""

from .extract import PlaneSegParams, extract_planes, preprocess, connected_components, sliding_window_normals, eigh3_smallest  # noqa: F401
from .pipeline import PlaneDecompositionPipeline, PlanarTerrain  # noqa: F401
from .contour import PlanarRegion, extract_boundaries, grow_convex_polygon  # noqa: F401
from .ransac import RansacParams, detect_planes  # noqa: F401
