"""Grid-map filter library — equivalent of plane_segmentation/grid_map_filters_rsl.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/ops/gridmap_filters.py``,
the reference's standalone C++ filter library
(grid_map_filters_rsl/src/*.cpp):

  inpainting:  minValues (inpainting.cpp:25-94), biLinearInterpolation
               (:96-203), resample (:244-289)
  smoothing:   median / boxBlur / gaussianBlur (smoothing.cpp:23-109)
  processing:  dilate / erode / outline / applyKernelFunction
               (processing.cpp:15-180)
  lookup:      maxValueBetweenLocations / valuesBetweenLocations (lookup.cpp)
  derivative:  estimateGradient / estimateGradientAndCurvature
               (GridMapDerivative.cpp:28-76)

All are NaN-aware: NaN marks missing cells, matching grid_map semantics.
Every function takes and returns tensors on one device.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .geometry import true_div

__all__ = [
    "inpaint_min_values",
    "inpaint_bilinear",
    "resample",
    "median_filter",
    "box_blur",
    "gaussian_blur",
    "dilate",
    "erode",
    "outline",
    "shifted_window_stack",
    "apply_kernel_function",
    "values_between_locations",
    "max_value_between_locations",
    "project_to_map_with_margin",
    "estimate_gradient",
    "estimate_gradient_and_curvature",
]

# the fixed-point loop of ``inpaint_min_values`` asks the device whether its
# last round changed anything once per this many rounds (one read-back
# each); rounds past the fixed point change nothing, so the result is the
# fixed point whatever this is
FIXED_POINT_CHECK_EVERY = 8


def _shift_fill(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """x shifted by (dy, dx) along its two axes, the revealed rows and
    columns set to ``fill`` (no wraparound)."""
    out = torch.roll(x, (dy, dx), dims=(0, 1))
    if dy > 0:
        out[:dy] = fill
    elif dy < 0:
        out[dy:] = fill
    if dx > 0:
        out[:, :dx] = fill
    elif dx < 0:
        out[:, dx:] = fill
    return out


def _shift_nan(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift with NaN fill (no wraparound)."""
    return _shift_fill(x, dy, dx, math.nan)


def _pad_edge(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """numpy's ``pad(mode="edge")`` of a 2-D tensor."""
    return F.pad(x[None, None], (left, right, top, bottom), mode="replicate")[0, 0]


def inpaint_min_values(h: torch.Tensor, iterations: int = 0) -> torch.Tensor:
    """Min-of-neighbors flood fill to the reference's fixed point
    (inpainting.cpp:25-94): every NaN-connected region converges to the
    MINIMUM finite value along its whole contour. iterations=0 (default)
    iterates to that fixed point, capped like the JAX package's while_loop
    at 1 + H*W rounds; iterations>0 runs that many rounds. All-NaN maps stay
    NaN."""
    missing = ~torch.isfinite(h)
    work = torch.where(missing, math.inf, h)

    def round_fn(w):
        best = w
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            # out-of-map neighbors contribute +inf (no wraparound)
            best = torch.minimum(best, _shift_fill(w, dy, dx, math.inf))
        return torch.where(missing, best, w)

    if iterations > 0:
        for _ in range(iterations):
            work = round_fn(work)
    else:
        remaining = 1 + h.shape[0] * h.shape[1]
        while remaining > 0:
            for _ in range(min(FIXED_POINT_CHECK_EVERY, remaining)):
                prev, work = work, round_fn(work)
                remaining -= 1
            if not bool(torch.any(work != prev)):
                break
    return torch.where(torch.isinf(work), math.nan, work)


def inpaint_bilinear(h: torch.Tensor, iterations: int = 32) -> torch.Tensor:
    """Neighbor-mean diffusion fill (the biLinearInterpolation analogue,
    inpainting.cpp:96-203): each missing cell takes the mean of its finite
    4-neighbors, iterated to flood the hole from its rim."""
    hh = h
    for _ in range(iterations):
        missing = ~torch.isfinite(hh)
        s = torch.zeros_like(hh)
        c = torch.zeros_like(hh)
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            nb = _shift_nan(hh, dy, dx)
            ok = torch.isfinite(nb)
            s = s + torch.where(ok, nb, 0.0)
            c = c + ok
        fill = s / torch.clamp(c, min=1.0)
        hh = torch.where(missing & (c > 0), fill, hh)
    return hh


def resample(h: torch.Tensor, out_shape: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resample (inpainting.cpp:244-289 / cv::resize INTER_LINEAR:
    half-pixel centers, no antialiasing on downscale)."""
    return F.interpolate(
        h[None, None], size=tuple(out_shape), mode="bilinear", align_corners=False, antialias=False
    )[0, 0]


def median_filter(h: torch.Tensor, size: int = 3) -> torch.Tensor:
    """NaN-aware kxk median: holes are excluded, an even count of finite
    values takes the mean of the middle two (``jnp.nanmedian``), all-NaN
    windows stay NaN."""
    pad = size // 2
    H, W = h.shape
    p = _pad_edge(h, pad, pad, pad, pad)
    stack = torch.stack([p[dy : dy + H, dx : dx + W] for dy in range(size) for dx in range(size)])
    srt = torch.sort(stack, dim=0).values          # NaN last
    count = torch.sum(~torch.isnan(stack), dim=0)
    q = 0.5 * (count - 1).to(h.dtype)
    last = torch.clamp(count - 1, min=0)
    low = torch.minimum(torch.clamp(torch.floor(q), min=0).to(torch.int64), last)
    high = torch.minimum(torch.clamp(torch.ceil(q), min=0).to(torch.int64), last)
    lo = torch.gather(srt, 0, low[None])[0]
    hi = torch.gather(srt, 0, high[None])[0]
    return (lo + hi) * 0.5


def box_blur(h: torch.Tensor, size: int = 3, passes: int = 1) -> torch.Tensor:
    """NaN-aware box blur: averages the finite neighbors only, so a hole
    neither poisons its neighborhood nor grows with repeated passes."""
    pad = size // 2
    out = h
    for _ in range(passes):
        fin = torch.isfinite(out)
        p = _pad_edge(torch.where(fin, out, 0.0), pad, pad, pad, pad)
        pm = _pad_edge(fin.to(h.dtype), pad, pad, pad, pad)
        acc = torch.zeros_like(out)
        cnt = torch.zeros_like(out)
        for dy in range(size):
            for dx in range(size):
                acc = acc + p[dy : dy + h.shape[0], dx : dx + h.shape[1]]
                cnt = cnt + pm[dy : dy + h.shape[0], dx : dx + h.shape[1]]
        out = torch.where(cnt > 0, acc / torch.clamp(cnt, min=1.0), math.nan)
    return out


def gaussian_blur(h: torch.Tensor, size: int = 5, sigma: float = 1.0) -> torch.Tensor:
    """NaN-aware separable Gaussian: per-pass mask-renormalized weights."""
    pad = size // 2
    xs = (torch.arange(size, device=h.device) - pad).to(torch.float32)
    k = torch.exp(true_div(-(xs**2), 2 * sigma**2))
    k = k / torch.sum(k)

    def pass_1d(v, axis):
        fin = torch.isfinite(v)
        vz = torch.where(fin, v, 0.0)
        m = fin.to(v.dtype)
        pads = (pad, pad, 0, 0) if axis == 1 else (0, 0, pad, pad)
        pv = _pad_edge(vz, pads[2], pads[3], pads[0], pads[1])
        pm = _pad_edge(m, pads[2], pads[3], pads[0], pads[1])
        if axis == 1:
            num = sum(k[i] * pv[:, i : i + v.shape[1]] for i in range(size))
            den = sum(k[i] * pm[:, i : i + v.shape[1]] for i in range(size))
        else:
            num = sum(k[i] * pv[i : i + v.shape[0], :] for i in range(size))
            den = sum(k[i] * pm[i : i + v.shape[0], :] for i in range(size))
        return torch.where(den > 0, num / torch.clamp(den, min=1e-30), math.nan)

    return pass_1d(pass_1d(h, 1), 0)


def shifted_window_stack(h: torch.Tensor, size: int) -> torch.Tensor:
    """(k*k, H, W) neighborhood stack with the grid_map_filters_rsl border
    rule: the kxk window is CLAMPED to lie fully inside the map, i.e. near
    borders it SHIFTS instead of truncating/replicating
    (processing.cpp:36-50 — cornerId = clamp(id - half, 0, N - k)).
    Entry (i*k+j) holds h[corner_r(r)+i, corner_c(c)+j]."""
    H, W = h.shape
    half = (size - 1) // 2
    cr = torch.clamp(torch.arange(H, device=h.device) - half, 0, H - size)
    cc = torch.clamp(torch.arange(W, device=h.device) - half, 0, W - size)
    planes = []
    for dy in range(size):
        hr = h[cr + dy, :]
        for dx in range(size):
            planes.append(hr[:, cc + dx])
    return torch.stack(planes)


def dilate(h: torch.Tensor, size: int = 3, inpaint: bool = False) -> torch.Tensor:
    """Max-of-finites dilation with the shifted-window border rule
    (processing.cpp:15-60): all-NaN windows fall back to the centre
    value; NaN centres stay NaN unless inpaint=True."""
    stack = shifted_window_stack(h, size)
    mx = torch.amax(torch.where(torch.isfinite(stack), stack, -math.inf), dim=0)
    out = torch.where(torch.isfinite(mx), mx, h)
    if not inpaint:
        out = torch.where(torch.isfinite(h), out, math.nan)
    return out


def erode(h: torch.Tensor, size: int = 3, inpaint: bool = False) -> torch.Tensor:
    """Min-of-finites erosion, shifted-window border rule (processing.cpp:62-107)."""
    stack = shifted_window_stack(h, size)
    mn = torch.amin(torch.where(torch.isfinite(stack), stack, math.inf), dim=0)
    out = torch.where(torch.isfinite(mn), mn, h)
    if not inpaint:
        out = torch.where(torch.isfinite(h), out, math.nan)
    return out


def outline(mask: torch.Tensor) -> torch.Tensor:
    """Boundary cells of a boolean region (processing.cpp outline)."""
    m = mask.to(torch.bool)
    inner = m
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        inner = inner & _shift_fill(m, dy, dx, False)
    return m & ~inner


def apply_kernel_function(h: torch.Tensor, size: int, fn) -> torch.Tensor:
    """Generic kxk neighborhood reduce: fn(stack (k*k, H, W)) -> (H, W)
    (processing.cpp:145-180 applyKernelFunction; used for the 45-degree
    cone dilation in Postprocessing.cpp:73-144). Stack entry (i*k+j)
    corresponds to block element (i, j), with the reference's
    shifted-window border rule (window clamped fully inside the map)."""
    return fn(shifted_window_stack(h, size))


def _unit_linspace(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` with its rounding: XLA computes the i-th
    sample as i times the rounded 1/(n-1) (not as i/(n-1), nor as
    ``torch.linspace`` does), and a sample on a cell edge must fall into the
    same cell."""
    if n <= 1:
        return torch.zeros((max(n, 0),), dtype=dtype, device=device)
    step = torch.tensor(1.0 / (n - 1), dtype=dtype, device=device)
    ts = torch.arange(n - 1, dtype=dtype, device=device) * step
    return torch.cat([ts, torch.ones((1,), dtype=dtype, device=device)])


def values_between_locations(
    h: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor, n_samples: int, resolution: float,
    origin: torch.Tensor = None,
) -> torch.Tensor:
    """Heights along the segment p0→p1 (lookup.cpp valuesBetweenLocations)."""
    if origin is None:
        origin = torch.zeros((2,), dtype=h.dtype, device=h.device)
    ts = _unit_linspace(n_samples, h.dtype, h.device)
    pts = p0[None] + ts[:, None] * (p1 - p0)[None]
    shape = torch.tensor(h.shape, dtype=h.dtype, device=h.device)
    f = true_div(pts - origin[None], resolution) + 0.5 * shape[None]
    # truncation toward zero, then the clamp into the grid
    ij = torch.minimum(torch.clamp(torch.trunc(f), min=0), shape[None] - 1).to(torch.int64)
    return h[ij[:, 0], ij[:, 1]]


def max_value_between_locations(
    h: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor, n_samples: int, resolution: float,
    origin: torch.Tensor = None,
) -> torch.Tensor:
    """The largest non-NaN height along the segment; NaN if all are NaN."""
    vals = values_between_locations(h, p0, p1, n_samples, resolution, origin)
    nan = torch.isnan(vals)
    mx = torch.amax(torch.where(nan, -math.inf, vals))
    return torch.where(torch.all(nan), math.nan, mx)


def project_to_map_with_margin(
    position: torch.Tensor,       # (..., 2) world xy
    map_position: torch.Tensor,   # (2,) map center in world
    map_length: Tuple[float, float],
    margin: float = 0.0,
) -> torch.Tensor:
    """Clamp a world position into the map bounds shrunk by `margin`
    (lookup.cpp:73-96; margin is capped at half the map length)."""
    half = torch.tensor(map_length, dtype=position.dtype, device=position.device) * 0.5
    m = torch.minimum(torch.clamp(torch.tensor(margin, dtype=position.dtype, device=position.device), min=0.0),
                      torch.amin(half))
    lo = map_position - half + m
    hi = map_position + half - m
    return torch.minimum(torch.maximum(position, lo), hi)


def estimate_gradient(h: torch.Tensor, resolution: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradient (GridMapDerivative.cpp:28-49).

    grid_map convention: world position decreases as the index grows, so
    d/dx_world = (h[i-1] - h[i+1]) / (2*res).
    """
    gx = true_div(_shift_nan(h, 1, 0) - _shift_nan(h, -1, 0), 2 * resolution)
    gy = true_div(_shift_nan(h, 0, 1) - _shift_nan(h, 0, -1), 2 * resolution)
    return gx, gy


def estimate_gradient_and_curvature(
    h: torch.Tensor, resolution: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradient + Hessian entries (GridMapDerivative.cpp:51-76)."""
    gx, gy = estimate_gradient(h, resolution)
    r2 = resolution * resolution
    hxx = true_div(_shift_nan(h, -1, 0) - 2 * h + _shift_nan(h, 1, 0), r2)
    hyy = true_div(_shift_nan(h, 0, -1) - 2 * h + _shift_nan(h, 0, 1), r2)
    hxy = true_div(
        _shift_nan(h, -1, -1) - _shift_nan(h, -1, 1)
        - _shift_nan(h, 1, -1) + _shift_nan(h, 1, 1),
        4 * r2,
    )
    return gx, gy, hxx, hyy, hxy
