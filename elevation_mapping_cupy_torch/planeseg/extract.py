"""On-device plane extraction: sliding-window planarity + connected components.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/planeseg/extract.py``,
the re-derivation of the reference C++ pipeline
(plane_segmentation/convex_plane_decomposition/src/sliding_window_plane_extraction/
SlidingWindowPlaneExtractor.cpp):

  * per-cell kxk window covariance → closed-form symmetric 3x3 eigensolver →
    surface normal + mean-squared plane error (:19-41, :82-110), as k²
    shifted-slice sums over the whole grid
  * local planarity test (:112-118)
  * optional morphological opening (:137-143)
  * connected components (cv::connectedComponents, :147-150) as iterative
    min-label propagation with pointer jumps, to a fixed point
    (``ops/gridmap_filters.py::fixed_point``)
  * per-label plane fit + global planarity / inclination gates (:152-218):
    the per-label moments and the "any bad cell" reduction are two launches
    of the scatter-add kernel K1 (``ops/cuda_scatter.py``) over
    ``max_labels + 1`` bins. CGAL RANSAC refinement runs host-side
    (ransac.py).

Also includes the preprocessing stage (GridMapPreprocessing.cpp:14-39):
min-values inpaint → median denoise.

Every function takes (..., H, W) maps: leading axes are a batch of maps,
each computed on its own (where the JAX package has ``jax.vmap``).
Scalar divisions go through ``ops/geometry.py::true_div``, which rounds
alike on the CPU and the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..ops import cuda_scatter
from ..ops.geometry import fma32, true_div
from ..ops.gridmap_filters import _pad_edge, _shift_fill, fixed_point, inpaint_min_values, resample
from ..ops.scatter import smallest_unique

__all__ = [
    "PlaneSegParams",
    "PreprocessingParams",
    "PlaneExtraction",
    "eigh3_smallest",
    "sliding_window_normals",
    "connected_components",
    "extract_planes",
    "preprocess",
    "preprocess_and_extract",
    "resample_shape",
    "true_resolution",
]

# compact-label sentinel of the static unique: int32's largest value, as in
# the JAX package, so that the padded table stays sorted for searchsorted
LABEL_SENTINEL = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class PlaneSegParams:
    """Mirrors SlidingWindowPlaneExtractorParameters.h defaults."""

    kernel_size: int = 3
    planarity_opening_filter: int = 0
    plane_inclination_threshold: float = math.cos(math.radians(30.0))
    local_plane_inclination_threshold: float = math.cos(math.radians(35.0))
    plane_patch_error_threshold: float = 0.02
    min_number_points_per_label: int = 4
    connectivity: int = 4
    global_plane_fit_distance_error_threshold: float = 0.025
    global_plane_fit_angle_error_threshold_degrees: float = 25.0
    max_labels: int = 64               # static bound on plane count
    cc_iterations: int = 0             # 0 → 2*(H+W) default
    # host-side stage; reference default true
    # (SlidingWindowPlaneExtractorParameters.h:34)
    include_ransac_refinement: bool = True


@dataclasses.dataclass(frozen=True)
class PreprocessingParams:
    """Mirrors PreprocessingParameters (GridMapPreprocessing.h:9-16) and the
    deployed parameters.yaml `preprocessing:` block. resolution is the
    resample target: negative skips; the default 0.04 is the REFERENCE
    HEADER default (GridMapPreprocessing.h:10-11), so — exactly like the
    reference — a pipeline running on a map of any other resolution
    resamples to 0.04 m unless configured otherwise. The deployed value
    equals the deployed map resolution, i.e. a no-op there
    (changeResolution skips within 1e-6). Pass
    PreprocessingParams(resolution=-1.0) to extract on the native grid."""

    resolution: float = 0.04
    kernel_size: int = 3        # median kernel, clamped to [1, 5]
    number_of_repeats: int = 1  # deployed parameters.yaml value (header: 2)


def resample_shape(shape, old_res: float, new_res: float):
    """New grid dims after resample (inpainting.cpp:265-270: truncation)."""
    scaling = old_res / new_res
    return (int(shape[0] * scaling), int(shape[1] * scaling))


def true_resolution(old_shape, old_res: float, new_shape) -> float:
    """The 'true new resolution' after size truncation — average of both
    dimensions (inpainting.cpp:280-282)."""
    return 0.5 * (
        (old_shape[0] * old_res) / new_shape[0]
        + (old_shape[1] * old_res) / new_shape[1]
    )


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.cross`` of (..., 3) vectors, written out in its order."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (3) of ``a * b``, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _unit_z(like: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(like)
    out[..., 2] = 1.0
    return out


def eigh3_smallest(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched closed-form eigen-solve of symmetric 3x3 matrices.

    A: (..., 3, 3). Returns (lambda_min, lambda_mid, v_min) where v_min is the
    unit eigenvector of the smallest eigenvalue (the plane normal candidate).
    The trigonometric method as the JAX package writes it, not a library
    ``eigh``: LAPACK, cuSOLVER and XLA disagree on eigenvector signs.
    """
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]

    # XLA divides by a constant as a multiply by its float32 reciprocal
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) * (1.0 / 3.0)
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 * (1.0 / 6.0), min=1e-30))

    b00 = (a00 - q) / p
    b11 = (a11 - q) / p
    b22 = (a22 - q) / p
    b01 = a01 / p
    b02 = a02 / p
    b12 = a12 / p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detB * 0.5, -1.0, 1.0)
    phi = torch.arccos(r) * (1.0 / 3.0)
    e1 = q + 2.0 * p * torch.cos(phi)                       # largest
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    e2 = 3.0 * q - e1 - e3

    diagish = p2 < 1e-24
    e1 = torch.where(diagish, a00, e1)
    e2 = torch.where(diagish, a11, e2)
    e3 = torch.where(diagish, a22, e3)

    # eigenvector of e3: cross products of rows of (A - e3 I)
    r0 = torch.stack([a00 - e3, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - e3, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - e3], dim=-1)
    cand = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)], dim=-2)  # (..., 3 cands, 3)
    best = _dot3(cand, cand)                                                      # (..., 3)
    which = torch.argmax(best, dim=-1)
    v = torch.gather(cand, -2, which[..., None, None].expand(*which.shape, 1, 3))[..., 0, :]
    norm = torch.sqrt(torch.clamp(_dot3(v, v), min=1e-30))[..., None]
    v = v / norm
    degenerate = torch.amax(best, dim=-1) < 1e-30
    v = torch.where(degenerate[..., None], _unit_z(v), v)
    return e3, e2, v


def sliding_window_normals(
    height: torch.Tensor,    # (..., H, W) heights, NaN = missing
    resolution: float,
    params: PlaneSegParams,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell window plane fit. Returns (normals (..., 3, H, W), planar
    (..., H, W)).

    Edge cells (EMPTY edge handling) and cells with NaN centers are not
    planar; normals default to +Z flip like the reference. The k² window
    sums are taken in the JAX package's order, so they round alike.
    """
    H, W = height.shape[-2:]
    k = params.kernel_size
    half = (k - 1) // 2
    finite = torch.isfinite(height)
    z = torch.where(finite, height, 0.0)

    # accumulate window sums with shifted slices; offsets use the
    # window-local coordinates (-kr*res, -kc*res) like
    # computeNormalAndErrorForWindow
    zp = F.pad(z, (half, half, half, half))
    mp = F.pad(finite.to(z.dtype), (half, half, half, half))

    n = sx = sy = sz = sxx = sxy = sxz = syy = syz = szz = torch.zeros_like(z)
    for kr in range(k):
        for kc in range(k):
            x_o = -kr * resolution
            y_o = -kc * resolution
            zs = zp[..., kr : kr + H, kc : kc + W]
            ms = mp[..., kr : kr + H, kc : kc + W]
            n = n + ms
            sx = sx + x_o * ms
            sy = sy + y_o * ms
            sz = sz + zs * ms
            # x_o * x_o is a Python double, rounded once to float32, as in JAX
            sxx = sxx + x_o * x_o * ms
            sxy = sxy + x_o * y_o * ms
            sxz = sxz + x_o * zs * ms
            syy = syy + y_o * y_o * ms
            syz = syz + y_o * zs * ms
            szz = szz + zs * zs * ms

    safe_n = torch.clamp(n, min=1.0)
    mx = sx / safe_n
    my = sy / safe_n
    mz = sz / safe_n
    # XLA:CPU contracts each ``s/n - a*b`` into one FMA
    c00 = fma32(-mx, mx, sxx / safe_n)
    c01 = fma32(-mx, my, sxy / safe_n)
    c02 = fma32(-mx, mz, sxz / safe_n)
    c11 = fma32(-my, my, syy / safe_n)
    c12 = fma32(-my, mz, syz / safe_n)
    c22 = fma32(-mz, mz, szz / safe_n)
    cov = torch.stack(
        [
            torch.stack([c00, c01, c02], -1),
            torch.stack([c01, c11, c12], -1),
            torch.stack([c02, c12, c22], -1),
        ],
        dim=-2,
    )
    lam_min, lam_mid, v = eigh3_smallest(cov)
    flip = v[..., 2] < 0
    v = torch.where(flip[..., None], -v, v)
    defined = lam_mid > 1e-8
    sq_err = torch.where(defined, torch.clamp(lam_min, min=0.0), 1e30)
    unit_z = _unit_z(v)
    v = torch.where(defined[..., None], v, unit_z)

    enough = n >= 3
    sq_err = torch.where(enough, sq_err, 1e30)
    v = torch.where(enough[..., None], v, unit_z)

    thresh2 = params.plane_patch_error_threshold**2
    planar = (sq_err < thresh2) & (v[..., 2] > params.local_plane_inclination_threshold)

    # EMPTY edge handling: windows not fully inside are not visited
    row = torch.arange(H, device=height.device)[:, None]
    col = torch.arange(W, device=height.device)[None, :]
    interior = (row >= half) & (row < H - half) & (col >= half) & (col < W - half)
    planar = planar & interior & finite

    if params.planarity_opening_filter > 0:
        r = params.planarity_opening_filter
        planar = _morph_cross(planar, r, erode=True)
        planar = _morph_cross(planar, r, erode=False)

    normals = torch.movedim(torch.where(interior[..., None], v, 0.0), -1, -3)
    return normals, planar


def _morph_cross(mask: torch.Tensor, r: int, erode: bool) -> torch.Tensor:
    """Morphological erode/dilate with a cross structuring element of radius r
    (cv::MORPH_CROSS), BORDER_REPLICATE, over the last two axes."""
    out = mask
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if abs(dy) + abs(dx) > r or (dy == 0 and dx == 0):
                continue
            shifted = torch.roll(mask, (dy, dx), dims=(-2, -1))
            # replicate border: re-fill wrapped rows/cols with edge values
            if dy > 0:
                shifted[..., :dy, :] = shifted[..., dy : dy + 1, :]
            elif dy < 0:
                shifted[..., dy:, :] = shifted[..., dy - 1 : dy, :]
            if dx > 0:
                shifted[..., :dx] = shifted[..., dx : dx + 1]
            elif dx < 0:
                shifted[..., dx:] = shifted[..., dx - 1 : dx]
            out = out & shifted if erode else out | shifted
    return out


def connected_components(mask: torch.Tensor, connectivity: int = 4, max_iters: int = 0) -> torch.Tensor:
    """4/8-connected component labels: 0 = background, components keep the
    (flat-index+1) of their minimal member — made compact by extract_planes.

    Each round does one neighbor min-propagation followed by a pointer-jump
    (label <- label of the cell that coined the label), so convergence is
    O(log diameter) rounds instead of O(diameter): a label value v encodes
    flat cell index v-1, which is always a mask cell of the same component,
    so hopping to its current label is monotone-decreasing and stays inside
    the component.

    The JAX package runs one round, then a ``while_loop`` of at most
    ``max_iters`` (0: 2*(H+W)) more while a round changes something; here
    ``fixed_point`` runs the same rounds under the same cap. ``mask`` is
    (..., H, W); each map of a batch keeps its own flat indices."""
    H, W = mask.shape[-2:]
    m = mask.reshape(-1, H, W)
    B = m.shape[0]
    if max_iters <= 0:
        max_iters = 2 * (H + W)
    init = torch.where(m, torch.arange(1, H * W + 1, device=mask.device).reshape(H, W), 0)
    big = H * W + 2

    if connectivity == 4:
        offsets = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    else:
        offsets = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]

    def step(labels):
        best = torch.where(m, labels, big)
        for dy, dx in offsets:
            # zero the wrapped borders
            nb = _shift_fill(labels, dy, dx, 0)
            best = torch.minimum(best, torch.where(m & (nb > 0), nb, big))
        best = torch.where(m, best, 0)
        # pointer jump (twice): follow the label to its coining cell's label
        for _ in range(2):
            flat = best.reshape(B, H * W)
            hop = torch.gather(flat, 1, torch.clamp(flat, min=1) - 1).reshape(B, H, W)
            best = torch.where(m, torch.minimum(best, hop), 0)
        return best

    labels, _ = fixed_point(step, step(init), max_iters)
    return labels.reshape(mask.shape)


class PlaneExtraction(NamedTuple):
    labels: torch.Tensor         # (..., H, W) int32 compact labels, 0 = background
    normals: torch.Tensor        # (..., 3, H, W) per-cell surface normals
    plane_normals: torch.Tensor  # (..., max_labels+1, 3) per-plane normal (row 0 unused)
    plane_support: torch.Tensor  # (..., max_labels+1, 3) per-plane support point
    plane_valid: torch.Tensor    # (..., max_labels+1) bool
    needs_refine: torch.Tensor   # (..., max_labels+1) bool — failed global-planarity (RANSAC candidates)


def preprocess_and_extract(
    height: torch.Tensor,
    resolution: float,
    params: PlaneSegParams,
    map_origin: torch.Tensor = None,
    kernel_size: int = 3,
    median_passes: int = 1,
    out_shape=None,
) -> Tuple[torch.Tensor, PlaneExtraction]:
    """Preprocess (inpaint → median → optional resample,
    GridMapPreprocessing.cpp:14-18) → extract_planes, for one (H, W) map or
    a (B, H, W) batch (the JAX package's ``preprocess_and_extract`` and its
    vmapped ``batched_preprocess_and_extract`` in one).

    `resolution` is the EXTRACTION resolution (post-resample); `out_shape`
    is the resampled grid size (resample_shape) or None to skip;
    `map_origin` ((2,) or (B, 2)) is the world position of cell (0,0) at
    that resolution."""
    h = preprocess(height, median_passes=median_passes, kernel_size=kernel_size)
    if out_shape is not None and tuple(out_shape) != tuple(h.shape[-2:]):
        # cv::resize INTER_LINEAR (inpainting.cpp:272-277): half-pixel
        # centers, NO antialiasing on downscale (plain bilinear sampling)
        h = resample(h, tuple(out_shape))
    return h, extract_planes(h, resolution, params, map_origin)


def extract_planes(
    height: torch.Tensor,          # (..., H, W), NaN = missing
    resolution: float,
    params: PlaneSegParams,
    map_origin: torch.Tensor = None,  # (..., 2) world position of cell (0,0)
) -> PlaneExtraction:
    H, W = height.shape[-2:]
    lead = height.shape[:-2]
    h = height.reshape(-1, H, W)
    B = h.shape[0]
    dev = h.device
    if map_origin is None:
        origin = torch.zeros((B, 2), dtype=h.dtype, device=dev)
    else:
        origin = torch.as_tensor(map_origin, dtype=h.dtype, device=dev).reshape(B, 2)

    normals, planar = sliding_window_normals(h, resolution, params)
    raw = connected_components(planar, params.connectivity).reshape(B, H * W)

    # compact to [1, max_labels]; pad with a +inf-like sentinel so the table
    # stays sorted for searchsorted (fill 0 would break the order).
    # Components beyond max_labels are dropped to background — never merged
    # onto another label's plane fit.
    L = params.max_labels + 1
    with_bg = torch.cat([raw, torch.zeros((B, 1), dtype=raw.dtype, device=dev)], dim=1)
    uniq = smallest_unique(with_bg, L, LABEL_SENTINEL).contiguous()
    compact = torch.clamp(torch.searchsorted(uniq, raw), 0, params.max_labels)
    found = torch.gather(uniq, 1, compact) == raw
    compact = torch.where((raw > 0) & found, compact, 0)

    # per-label plane fit in world coordinates (:167-175)
    row = torch.arange(H, dtype=h.dtype, device=dev)[:, None] * torch.ones((1, W), dtype=h.dtype, device=dev)
    col = torch.ones((H, 1), dtype=h.dtype, device=dev) * torch.arange(W, dtype=h.dtype, device=dev)[None, :]
    px = origin[:, 0, None, None] - row * resolution
    py = origin[:, 1, None, None] - col * resolution
    finite = torch.isfinite(h)
    pz = torch.where(finite, h, 0.0)

    # The 10 per-label moment sums are one K1 launch of 10 value streams
    # over L bins (the JAX package's one-hot HIGHEST-precision dot); cells
    # off the map's finite part are masked out, which is the JAX package's
    # multiply by ``ones``. The moments are taken about each component's
    # coining cell (flat index raw - 1, a finite cell of the component), not
    # about the world origin: the covariance is the same, but float32 sums
    # of small offsets in K1's order (or index_add_'s) lose far less than
    # sums of world coordinates, which XLA's blocked dot adds more
    # accurately than a sequential or atomic sum would. The first moments
    # of x and y are sums of whole-cell offsets: integers below 2**24, so
    # exact in any order, and the support's x and y do not depend on it.
    idx = compact.to(torch.int32)
    cell_ok = finite.reshape(B, H * W)
    p_flat = torch.stack([px, py, pz], dim=1).reshape(B, 3, H * W)
    coin = (torch.clamp(raw, min=1) - 1)[:, None, :]
    rc = torch.stack([row, col]).reshape(1, 2, H * W).expand(B, 2, H * W)
    dr, dc = (rc - torch.gather(rc, 2, coin.expand(B, 2, H * W))).unbind(1)   # whole cells
    dz = pz.reshape(B, H * W) - torch.gather(pz.reshape(B, H * W), 1, coin[:, 0])
    dx = dr * -resolution
    dy = dc * -resolution
    moments = torch.stack([torch.ones_like(dx), dr, dc, dz, dx * dx, dx * dy, dx * dz, dy * dy, dy * dz, dz * dz], 1)
    sums = cuda_scatter.scatter_add_streams(idx, cell_ok, moments, L)   # (B, 10, L)
    n, sr, sc, sz, sxx, sxy, sxz, syy, syz, szz = sums.unbind(1)
    safe_n = torch.clamp(n, min=1.0)
    mean_d = torch.stack([sr * -resolution, sc * -resolution, sz], -1) / safe_n[..., None]
    c00 = sxx / safe_n - mean_d[..., 0] ** 2
    c01 = sxy / safe_n - mean_d[..., 0] * mean_d[..., 1]
    c02 = sxz / safe_n - mean_d[..., 0] * mean_d[..., 2]
    c11 = syy / safe_n - mean_d[..., 1] ** 2
    c12 = syz / safe_n - mean_d[..., 1] * mean_d[..., 2]
    c22 = szz / safe_n - mean_d[..., 2] ** 2
    cov = torch.stack(
        [
            torch.stack([c00, c01, c02], -1),
            torch.stack([c01, c11, c12], -1),
            torch.stack([c02, c12, c22], -1),
        ],
        dim=-2,
    )
    # a label's coining cell is its raw value - 1 (the unique table holds
    # the raw values); an empty slot's mean stays 0, as in the JAX package
    coin_label = (torch.clamp(uniq, 1, H * W) - 1)[:, None, :].expand(B, 3, L)
    mean = mean_d + torch.where(n[..., None] > 0, torch.gather(p_flat, 2, coin_label).transpose(1, 2), 0.0)
    _, _, pn = eigh3_smallest(cov)
    pn = torch.where(pn[..., 2:3] < 0, -pn, pn)                       # (B, L, 3)

    # global planarity check per cell, reduced per label (:276-299)
    cells3 = compact[..., None].expand(B, H * W, 3)
    pn_cells = torch.gather(pn, 1, cells3).reshape(B, H, W, 3)
    mean_cells = torch.gather(mean, 1, cells3).reshape(B, H, W, 3)
    ndotp = pn_cells[..., 0] * px + pn_cells[..., 1] * py + pn_cells[..., 2] * pz
    ndots = _dot3(pn_cells, mean_cells)
    dist_err = torch.abs(ndotp - ndots)
    ndotn = _dot3(pn_cells, torch.movedim(normals, -3, -1))
    cos_thresh = math.cos(math.radians(params.global_plane_fit_angle_error_threshold_degrees))
    bad = (dist_err > params.global_plane_fit_distance_error_threshold) | (ndotn < cos_thresh)
    bad = bad & (compact.reshape(B, H, W) > 0) & finite
    # per-label "any bad cell": a second K1 launch (a count > 0)
    label_bad = cuda_scatter.scatter_add_streams(
        idx, cell_ok, bad.to(h.dtype).reshape(B, 1, H * W), L
    )[:, 0] > 0.5

    enough = (n >= params.min_number_points_per_label) & (n >= 3)
    within_incl = pn[..., 2] > params.plane_inclination_threshold
    valid = enough & within_incl & ~label_bad
    valid[:, 0] = False
    needs_refine = enough & label_bad
    needs_refine[:, 0] = False

    # labels failing all gates go to background (:198-216)
    keep = torch.gather(valid | needs_refine, 1, compact)
    labels_out = torch.where(keep, compact, 0).to(torch.int32)

    return PlaneExtraction(
        labels=labels_out.reshape(*lead, H, W),
        normals=normals.reshape(*lead, 3, H, W),
        plane_normals=pn.reshape(*lead, L, 3),
        plane_support=mean.reshape(*lead, L, 3),
        plane_valid=valid.reshape(*lead, L),
        needs_refine=needs_refine.reshape(*lead, L),
    )


# ---------------------------------------------------------------------------
# preprocessing (GridMapPreprocessing.cpp:14-39)
# ---------------------------------------------------------------------------

def preprocess(
    height: torch.Tensor,
    inpaint_iters: int = 0,
    median_passes: int = 1,
    kernel_size: int = 3,
) -> torch.Tensor:
    """GridMapPreprocessing inpaint + denoise (GridMapPreprocessing.cpp:14-39):
    min-values inpaint to the reference fixed point (every NaN-connected
    region takes the MINIMUM value along its contour — inpainting.cpp:25-94
    keeps lowering filled cells until nothing changes) then kxk median
    denoise repeated median_passes times (kernel clamped to [1,5] like
    denoise(), which bounds cv::medianBlur's float support). The median
    picks one of the window's values, so it is exact.
    """
    H, W = height.shape[-2:]
    h = inpaint_min_values(height, iterations=inpaint_iters)

    k = max(1, min(kernel_size, 5))
    if k % 2 == 0:
        k += 1
    half = k // 2
    for _ in range(median_passes):
        if k == 1:
            break
        pad = _pad_edge(h, half, half, half, half)
        center = pad[..., half : half + H, half : half + W]
        # NaN neighbors (only possible in isolated all-NaN islands) fall
        # back to the center value so min/max exchanges stay NaN-free
        v: List[torch.Tensor] = []
        for dy in range(k):
            for dx in range(k):
                s = pad[..., dy : dy + H, dx : dx + W]
                v.append(torch.where(torch.isfinite(s), s, center))
        med = _median9(v) if k == 3 else torch.sort(torch.stack(v), dim=0).values[k * k // 2]
        h = torch.where(torch.isfinite(h), med, h)
    return h


def _median9(v):
    """Median of 9 via Paeth's 19-exchange network — elementwise min/max,
    no sort."""
    v = list(v)

    def mnmx(i, j):
        lo = torch.minimum(v[i], v[j])
        hi = torch.maximum(v[i], v[j])
        v[i], v[j] = lo, hi

    for i, j in [(1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
                 (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
                 (4, 2), (6, 4), (4, 2)]:
        mnmx(i, j)
    return v[4]
