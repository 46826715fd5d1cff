"""Plane decomposition pipeline (PlaneDecompositionPipeline equivalent).

PyTorch counterpart of ``elevation_mapping_cupy_tpu/planeseg/pipeline.py``.
Orchestrates: preprocess (inpaint + denoise + resample, on the device) →
sliding-window plane extraction + connected components + plane fits (on
the device, extract.py) → optional host RANSAC refinement for labels
failing the global planarity gate → contour extraction + insets + convex
approximation (host, contour.py) → full postprocessing (region height
offsets, non-planar dilation, smooth_planar layer — postprocess.py, on the
device).

The pipeline runs on a CUDA device unless the caller passes
``device="cpu"``; what it returns is host NumPy, as in the JAX package.

Reference: plane_segmentation/convex_plane_decomposition/src/
PlaneDecompositionPipeline.cpp:13-39, GridMapPreprocessing.cpp:14-39,
Postprocessing.cpp:14-31.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..mapper import resolve_device
from .contour import PlanarRegion, extract_boundaries, grow_convex_polygon
from .extract import (
    PlaneSegParams,
    PreprocessingParams,
    preprocess_and_extract,
    resample_shape,
    true_resolution,
)
from .postprocess import PostprocessingParams, postprocess
from .ransac import RansacParams, detect_planes

__all__ = ["PlanarTerrain", "PlaneDecompositionPipeline"]

# update_batch()'s names for the stages that update() records
_BATCH_STAGES = {
    "sliding_window": "sliding_window_batch", "ransac": "ransac_batch",
    "contour_extraction": "contour_batch", "postprocess": "postprocess_batch",
}

_NUMPY_DTYPES = {
    torch.bool: np.bool_, torch.int16: np.int16, torch.int32: np.int32, torch.float32: np.float32,
}


def _read_back(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Host NumPy copies of device tensors in one transfer: their bytes are
    joined on the device and copied to the host at once, then split."""
    host = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        out.append(host[off : off + nbytes].view(_NUMPY_DTYPES[t.dtype]).reshape(t.shape).copy())
        off += nbytes
    return out


@dataclasses.dataclass
class PlanarTerrain:
    regions: List[PlanarRegion]
    labels: np.ndarray                # (H, W) final labels (post-resample grid)
    filtered_map: np.ndarray          # preprocessed height map ("elevation_before_postprocess")
    elevation: np.ndarray             # postprocessed elevation (non-planar dilation + offsets)
    plane_classification: np.ndarray  # (H, W) planar = 1.0 / non-planar = 0.0
    smooth_planar: np.ndarray         # postprocessed smooth layer
    resolution: float                 # post-resample resolution
    map_origin: Tuple[float, float]   # world position of cell (0,0) post-resample
    timings: Dict[str, float]


class PlaneDecompositionPipeline:
    """Stateful wrapper with per-stage timing stats (the reference prints a
    benchmark table at node destruction, ConvexPlaneDecompositionRos.cpp:28-48;
    here: .timing_report()). Stage times are host clock; each ends in a
    read-back, which waits for the device."""

    def __init__(
        self,
        resolution: float,
        params: PlaneSegParams = PlaneSegParams(),
        ransac: RansacParams = RansacParams(),
        preprocessing: PreprocessingParams = PreprocessingParams(),
        postprocessing: PostprocessingParams = PostprocessingParams(),
        device: Union[None, str, torch.device] = None,
    ):
        self.resolution = resolution
        self.params = params
        self.ransac = ransac
        self.preprocessing = preprocessing
        self.postprocessing = postprocessing
        self.device = resolve_device(device)
        self._stats: Dict[str, List[float]] = {}

    def _record(self, name: str, dt: float) -> None:
        self._stats.setdefault(name, []).append(dt)

    def timing_report(self) -> str:
        lines = ["stage            avg_ms    max_ms    n"]
        for k, v in self._stats.items():
            a = np.asarray(v) * 1e3
            lines.append(f"{k:<16} {a.mean():8.2f} {a.max():9.2f} {len(a):4d}")
        return "\n".join(lines)

    def _ransac_refine(
        self, labels, hnp, normals_np,
        plane_normals, plane_support, plane_valid,
        needs_refine, res, origin,
    ):
        """Host RANSAC re-segmentation of labels that failed the global
        planarity gate (Pipeline.cpp's RANSAC branch). Mutates the label
        image in place; may grow the plane tables."""
        normals_np = np.moveaxis(normals_np, 0, -1)
        next_label = int(labels.max()) + 1
        rows, cols = np.indices(labels.shape)
        px = origin[0] - rows * res
        py = origin[1] - cols * res
        for lab in np.where(needs_refine)[0]:
            member = labels == lab
            labels[member] = 0
            pts = np.stack([px[member], py[member], hnp[member]], axis=-1)
            nrms = normals_np[member]
            planes = detect_planes(pts, nrms, self.ransac, seed=0)
            flat_member = np.where(member.reshape(-1))[0]
            reuse = True
            for normal, support, idxs in planes:
                if normal[2] <= self.params.plane_inclination_threshold:
                    continue
                newlab = lab if reuse else next_label
                if not reuse:
                    next_label += 1
                reuse = False
                if newlab >= len(plane_normals):
                    plane_normals = np.vstack([plane_normals, normal[None]])
                    plane_support = np.vstack([plane_support, support[None]])
                    plane_valid = np.append(plane_valid, True)
                else:
                    plane_normals[newlab] = normal
                    plane_support[newlab] = support
                    plane_valid[newlab] = True
                fl = flat_member[idxs]
                labels.reshape(-1)[fl] = newlab
        return labels, plane_normals, plane_support, plane_valid

    def _resample_target(self, shape, map_origin):
        """Resolve the (out_shape, true resolution, post-resample origin) of
        the optional changeResolution stage (GridMapPreprocessing.cpp:25-31;
        grid_map keeps the map CENTER fixed across resample)."""
        target = self.preprocessing.resolution
        res = self.resolution
        origin = (float(map_origin[0]), float(map_origin[1]))
        if target <= 0.0 or abs(self.resolution - target) < 1e-6:
            return None, res, origin
        out_shape = resample_shape(shape, self.resolution, target)
        res = true_resolution(shape, self.resolution, out_shape)
        origin = tuple(
            origin[a]
            - (shape[a] - 1) / 2.0 * self.resolution
            + (out_shape[a] - 1) / 2.0 * res
            for a in (0, 1)
        )
        return out_shape, res, origin

    def _extract(self, heights: np.ndarray, origins, res: float, out_shape):
        """The device stage for a (B, H, W) batch, then one read-back of the
        labels (int16) and the plane tables."""
        h, ext = preprocess_and_extract(
            torch.from_numpy(heights).to(self.device),
            res,
            self.params,
            torch.tensor(np.asarray(origins, np.float32), device=self.device),
            kernel_size=self.preprocessing.kernel_size,
            median_passes=self.preprocessing.number_of_repeats,
            out_shape=out_shape,
        )
        # label ids fit int16 (≤ max_labels+1): halves the copy
        labels, plane_normals, plane_support, plane_valid, needs_refine = _read_back(
            ext.labels.to(torch.int16), ext.plane_normals, ext.plane_support, ext.plane_valid, ext.needs_refine
        )
        return h, ext, labels.astype(np.int32), plane_normals, plane_support, plane_valid, needs_refine

    def _decompose(self, heights: np.ndarray, origins, res: float, out_shape, batch: bool) -> List[PlanarTerrain]:
        """Every stage for a (B, H, W) batch: the device stage, host RANSAC
        refinement and contours per map while the device postprocess runs,
        and one final read-back. Stage times go under update()'s names, or
        under update_batch()'s (``_BATCH_STAGES``) when ``batch``."""
        B = heights.shape[0]
        timings = {"preprocess": 0.0}

        # preprocess + sliding-window extraction run as one device stage,
        # and everything the host stages need comes back in one read-back
        t0 = time.perf_counter()
        hs, ext, labels, plane_normals, plane_support, plane_valid, needs_refine = self._extract(
            heights, origins, res, out_shape
        )
        timings["sliding_window"] = time.perf_counter() - t0

        # host-side RANSAC refinement for non-globally-planar labels
        t0 = time.perf_counter()
        tables = [(plane_normals[b], plane_support[b], plane_valid[b]) for b in range(B)]
        if self.params.include_ransac_refinement and needs_refine.any():
            hnp, normals_np = _read_back(hs, ext.normals)
            for b in np.flatnonzero(needs_refine.any(axis=1)):
                labels[b], *tables[b] = self._ransac_refine(
                    labels[b], hnp[b], normals_np[b], *tables[b], needs_refine[b], res, origins[b]
                )
        timings["ransac"] = time.perf_counter() - t0

        # postprocess needs the FINAL labels (plane_classification =
        # labeledImage > 0, PlaneDecompositionPipeline.cpp:31-37) so it is
        # queued now and runs on the device while the host extracts contours;
        # queueing its launches is host time, counted under "postprocess"
        t0 = time.perf_counter()
        masks = (labels > 0).astype(np.float32)
        elev_dev, smooth_dev = postprocess(hs, torch.from_numpy(masks).to(self.device), res, self.postprocessing)
        queue_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        regions = [extract_boundaries(labels[b], *tables[b], res, origins[b]) for b in range(B)]
        timings["contour_extraction"] = time.perf_counter() - t0

        # addHeightOffset on the planar regions (Postprocessing.cpp:65-71)
        t0 = time.perf_counter()
        z_off = self.postprocessing.extracted_planes_height_offset
        if z_off != 0.0:
            for r in (r for rs in regions for r in rs):
                r.support[2] += z_off
        filtered_np, elev_np, smooth_np = _read_back(hs, elev_dev, smooth_dev)
        timings["postprocess"] = queue_s + time.perf_counter() - t0

        if batch:
            for stage, name in _BATCH_STAGES.items():
                self._record(name, timings[stage])
            timings = {}
        else:
            timings["total"] = sum(timings.values())
            for stage, dt in timings.items():
                self._record(stage, dt)
        return [
            PlanarTerrain(
                regions=regions[b],
                labels=labels[b],
                filtered_map=filtered_np[b],
                elevation=elev_np[b],
                plane_classification=masks[b],
                smooth_planar=smooth_np[b],
                resolution=res,
                map_origin=origins[b],
                timings=timings,
            )
            for b in range(B)
        ]

    def update(self, height: np.ndarray, map_origin=(0.0, 0.0)) -> PlanarTerrain:
        height = np.ascontiguousarray(height, np.float32)
        # resample target (GridMapPreprocessing::changeResolution,
        # GridMapPreprocessing.cpp:25-31): skip if negative or within 1e-6
        out_shape, res, origin = self._resample_target(height.shape, map_origin)
        return self._decompose(height[None], [origin], res, out_shape, batch=False)[0]

    def update_batch(
        self, heights: np.ndarray, map_origins: Optional[np.ndarray] = None
    ) -> List[PlanarTerrain]:
        """Decompose B height maps with one batched device stage.

        One preprocess+extraction over the (B, H, W) batch (two K1 launches
        for all B maps) and one batched postprocess, with the host stages
        (RANSAC refinement, contour extraction) looped per map while the
        device postprocess is in flight. This is the multi-env (simulation
        / fleet) operating mode; the reference runs one decomposition node
        per robot and has no analogue. Semantics per map are identical to
        :meth:`update`, which is this with B = 1.
        """
        heights = np.ascontiguousarray(heights, np.float32)
        B = heights.shape[0]
        if map_origins is None:
            map_origins = np.zeros((B, 2), np.float32)
        out_shape, res, _ = self._resample_target(heights.shape[1:], (0.0, 0.0))
        origins = [self._resample_target(heights.shape[1:], map_origins[b])[2] for b in range(B)]
        return self._decompose(heights, origins, res, out_shape, batch=True)

    def convex_approximation(
        self, terrain: PlanarTerrain, query_xy: np.ndarray, n_vertices: int = 16
    ) -> Optional[np.ndarray]:
        """Grow a convex polygon inside the region containing/nearest the
        query (SegmentedPlaneProjection + ConvexRegionGrowing)."""
        from .contour import project_to_planar_region

        # hole-aware containing/nearest selection (a query over a raised
        # plane sits in the LOWER plane's hole — SegmentedPlaneProjection
        # .cpp:56-97); single source of truth with the projection helper
        hit = project_to_planar_region(np.asarray(query_xy, np.float64), terrain.regions)
        if hit is None:
            return None
        best, proj = hit
        # grow at the PROJECTED point (the reference demo does the same);
        # for a contained query the projection equals the query, otherwise
        # seeding at the raw query could start outside the polygon
        seed = np.asarray(proj[:2], np.float64)
        return grow_convex_polygon(
            best.boundary_with_holes.boundary,
            best.boundary_with_holes.holes,
            seed,
            n_vertices=n_vertices,
        )
