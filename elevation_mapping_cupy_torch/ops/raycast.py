"""Ray-cast visibility cleanup: the polar shadow cube and the exact march.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/ops/raycast.py``:
``resolve_raycast_mode``, the ``visibility_cleanup`` dispatcher,
``visibility_cleanup_polar``, ``visibility_cleanup_exact`` with its three
implementations (``scan``, ``flat``, ``gated``) and ``AdaptiveExactRouter``.
The three exact implementations are one kernel here, K2
(``ops/cuda_march.py``): ``scan`` and ``flat`` are the same launch without a
gate (every ray's steps end where the endpoint test starts to reject every
sample, which the JAX scan walks to no effect), ``gated`` has the segment
gate. On the card the polar cleanup's cube scans and its per-cell
evaluation are kernels too, ``csrc/polar_scan.cu`` (:func:`polar_scan`,
``SCAN_KERNEL``) and ``csrc/polar_evaluate.cu`` (:func:`polar_evaluate`,
``KERNEL``), with ``_polar_scan`` and ``_polar_evaluate`` as their plain
versions.

Race resolutions R1 (snapshot reads) and R3 (min-height upper-bound write)
per tests/golden/reference_numpy.py.

Every cleanup also takes a ``block`` (``geometry.Block``): the layers are
then one process's cells of a sharded map, the rays are all of them, and
each cell is cleaned up as on the whole map. ``reduce`` sums the gated
march's segment counts over the processes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from .. import tracing
from ..config import MapConfig
from ..kernels import CudaKernel, on_card
from . import cuda_march, scatter
from .geometry import Block, PointAssociation, true_div

__all__ = [
    "visibility_cleanup",
    "visibility_cleanup_exact",
    "visibility_cleanup_polar",
    "polar_evaluate",
    "launch_polar_evaluate",
    "KERNEL",
    "polar_scan",
    "launch_polar_scan",
    "SCAN_KERNEL",
    "resolve_raycast_mode",
    "resolve_exact_impl",
    "exact_precompute",
    "exact_gate",
    "AdaptiveExactRouter",
]

# `auto` picks the exact march only when it is at most this many steps and
# its work, times this ratio, is below the cube's (the JAX package's
# defaults for the same decision, raycast.py:54-55)
_AUTO_MAX_STEPS = 12
_AUTO_WORK_RATIO = 8
# exact impl `auto` picks the gated march once n_steps * max_points reaches
# this, the scan below it (raycast.py:56)
_FLAT_MIN_SAMPLES = 1 << 20
# gated march: steps per segment (C), cells per gate block (B) and the slack
# of the gate's comparison (raycast.py:66-67, 704). A segment spans at most
# (C - 1) * res / sqrt(2) = 4.95 cells, within the one-block reach of the
# 3x3 block dilation.
_GATE_SEG = 8
_GATE_BLOCK = 8
_GATE_EPS = 2e-4
# AdaptiveExactRouter: survivor fraction that routes the next update to the
# flat march, and the probe period's cap (raycast.py:83-84)
_GATE_SURV_ROUTE = 0.8
_GATE_PROBE_PERIOD = 8


def resolve_raycast_mode(cfg: MapConfig) -> str:
    """Static resolution of cfg.raycast_mode's "auto": the exact march only
    for short-ray configs whose march is much smaller than the shadow cube,
    polar otherwise (as in the JAX package, so both resolve alike)."""
    mode = cfg.raycast_mode
    if mode != "auto":
        return mode
    cube = cfg.azimuth_bins * (cfg.n_ray_steps + 2) * cfg.raycast_elevation_bins
    march = cfg.n_ray_steps * cfg.max_points
    return (
        "exact"
        if (cfg.n_ray_steps <= _AUTO_MAX_STEPS and march * _AUTO_WORK_RATIO < cube)
        else "polar"
    )


def resolve_exact_impl(cfg: MapConfig) -> str:
    """cfg.raycast_exact_impl with "auto" resolved: gated once the dense
    march reaches _FLAT_MIN_SAMPLES samples, scan below (raycast.py:166-176)."""
    impl = cfg.raycast_exact_impl
    if impl == "auto":
        return "gated" if cfg.n_ray_steps * cfg.max_points >= _FLAT_MIN_SAMPLES else "scan"
    if impl not in ("scan", "flat", "gated"):
        raise ValueError(f"unknown raycast_exact_impl {impl!r}")
    return impl


def _no_gate_aux(layers: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Aux of a cleanup that runs no gate: "everything survives" (one
    value per map of a batch)."""
    return {"gate_survivor_frac": torch.ones(layers.shape[:-3], dtype=layers.dtype, device=layers.device)}


def visibility_cleanup(
    layers: torch.Tensor,
    normal: torch.Tensor,
    assoc: PointAssociation,
    inlier_cnt: torch.Tensor,
    t: torch.Tensor,
    cfg: MapConfig,
    with_aux: bool = False,
    block: Optional[Block] = None,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Dispatch on cfg.raycast_mode ("polar" / "exact" / "auto").

    With ``with_aux=True`` returns ``(layers, aux)``; aux's
    ``gate_survivor_frac`` (0-d tensor, or one per map) is the gated march's
    segment survivor fraction, 1.0 for every other path, the signal
    :class:`AdaptiveExactRouter` routes on.

    A batch of maps (a leading axis on every argument) takes either cleanup
    in one pass over all maps: the polar cube's kernels once, the exact
    march as one K2 launch.
    With a ``block`` the layers are those cells of the map; ``reduce`` sums
    the gated march's segment counts over the processes of a sharded map.
    """
    if not cfg.enable_visibility_cleanup or cfg.n_ray_steps <= 0:
        return (layers, _no_gate_aux(layers)) if with_aux else layers
    mode = resolve_raycast_mode(cfg)
    if mode == "polar":
        out = visibility_cleanup_polar(layers, normal, assoc, inlier_cnt, t, cfg, block)
        return (out, _no_gate_aux(layers)) if with_aux else out
    if mode == "exact":
        return visibility_cleanup_exact(layers, normal, assoc, inlier_cnt, t, cfg, with_aux, block, reduce)
    raise ValueError(f"unknown raycast_mode {cfg.raycast_mode!r}")


# ---------------------------------------------------------------------------
# exact march
# ---------------------------------------------------------------------------

def exact_precompute(
    layers: torch.Tensor, normal: torch.Tensor, inlier_cnt: torch.Tensor, cfg: MapConfig
) -> torch.Tensor:
    """(..., n*n, 8) cell rows of the R1 snapshot (raycast.py:193-222):
    height, penetration slack min(var, 1) * 0.05, upper-bound threshold
    (+inf where the cell has no upper bound), code (1 invalid, 2 eligible to
    be hit, 0 neither), normal x, y, z, and a zero pad (K2 reads a row as two
    16-byte loads); a batch of maps in front. Selections only, so every
    comparison the march makes on it is the inline one."""
    lead = layers.shape[:-3]
    snap = layers.reshape(*lead, 7, -1).unbind(-2)
    nrm = normal.reshape(*lead, 3, -1).unbind(-2)
    ic = inlier_cnt.reshape(*lead, -1)
    q = torch.clamp(snap[1], max=1.0) * 0.05
    ub_thresh = torch.where(snap[6] < 0.5, math.inf, snap[5])
    is_invalid = snap[2] < 0.5
    hit_ok = ~is_invalid & (snap[4] >= 0.5) & ~((ic > cfg.wall_num_thresh) & (snap[4] < 1.0))
    code = torch.where(is_invalid, 1.0, torch.where(hit_ok, 2.0, 0.0)).to(layers.dtype)
    pad = torch.zeros_like(q)
    return torch.stack([snap[0], q, ub_thresh, code, nrm[0], nrm[1], nrm[2], pad], dim=-1)


def exact_gate(pack: torch.Tensor, cfg: MapConfig, block: Optional[Block] = None) -> cuda_march.Gate:
    """Gate table of ``_exact_gated`` (raycast.py:689-704): per cell the
    height below which a sample can write (the upper bound of an invalid
    cell, the penetration threshold of an eligible one, -inf otherwise and
    on the border), its max over gate blocks of B x B cells, dilated by the
    3x3 gate block neighbourhood; one table per map of a batched ``pack``.

    For the cells of a ``block`` the table covers the gate blocks within one
    of the block's (cells outside the block write nothing here, -inf), so a
    segment that starts outside it cannot reach the block: the gate stays
    exact."""
    n = cfg.cell_n
    B = _GATE_BLOCK
    if block is None:
        block = Block.whole(n, n)
    lead = pack.shape[:-2]
    zgate = torch.where(
        pack[..., 3] == 1.0,
        pack[..., 2],
        torch.where(pack[..., 3] == 2.0, pack[..., 0] - 0.01 + pack[..., 1], -math.inf),
    ).reshape(-1, block.h, block.w)
    nb = -(-n // B)
    g0 = (max(block.r0 // B - 1, 0), max(block.c0 // B - 1, 0))
    g1 = (min(-(-(block.r0 + block.h) // B) + 1, nb), min(-(-(block.c0 + block.w) // B) + 1, nb))
    rows, cols = g1[0] - g0[0], g1[1] - g0[1]
    zpad = torch.full((zgate.shape[0], rows * B, cols * B), -math.inf, dtype=pack.dtype, device=pack.device)
    # the border never writes: the block's cells within rows and columns
    # [1, n - 1), at their place in the window
    r = (max(block.r0, 1), min(block.r0 + block.h, n - 1))
    c = (max(block.c0, 1), min(block.c0 + block.w, n - 1))
    zpad[:, r[0] - g0[0] * B : r[1] - g0[0] * B, c[0] - g0[1] * B : c[1] - g0[1] * B] = \
        zgate[:, r[0] - block.r0 : r[1] - block.r0, c[0] - block.c0 : c[1] - block.c0]
    blkmax = zpad.reshape(-1, rows, B, cols, B).amax(dim=(2, 4))
    table = F.max_pool2d(blkmax[:, None], 3, stride=1, padding=1)[:, 0]
    return cuda_march.Gate(table.reshape(*lead, rows, cols).contiguous(), _GATE_SEG, B, _GATE_EPS, g0)


def visibility_cleanup_exact(
    layers: torch.Tensor,
    normal: torch.Tensor,
    assoc: PointAssociation,
    inlier_cnt: torch.Tensor,
    t: torch.Tensor,
    cfg: MapConfig,
    with_aux: bool = False,
    block: Optional[Block] = None,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Exact visibility cleanup (raycast.py:142-190): every ray marched in
    steps of res/sqrt(2), each fresh sample in a cell it penetrates
    decrementing the cell's validity and adding to its variance, samples
    below an invalid cell's upper bound lowering it. One K2 launch for one
    map or a batch of maps (a leading axis on every argument): on the card,
    for whole maps, that launch also builds the pack and the gate and writes
    the new layers (``cuda_march.exact_cleanup``); elsewhere those steps are
    :func:`exact_precompute`, :func:`exact_gate` and the update below. The gated
    march also returns its segment survivor fraction in aux, one per map
    (0.0 on an empty march, raycast.py:906-914).

    On a ``block`` K2 writes only the block's cells, and its gate passes
    only segments that can reach them; ``reduce`` sums the segment counts
    over the processes, so the fraction is that of (process, segment) pairs
    that survive, the work of the whole group."""
    impl = resolve_exact_impl(cfg)  # an unknown implementation raises here
    if not cfg.enable_visibility_cleanup or cfg.n_ray_steps <= 0:
        return (layers, _no_gate_aux(layers)) if with_aux else layers
    if impl != "scan" and layers.dtype.itemsize != 4:
        raise TypeError(
            f"the {impl} exact march requires a 32-bit layer dtype (got {layers.dtype}); "
            "use raycast_exact_impl='scan' for other dtypes"
        )
    with tracing.span("raycast.exact", stream=layers.is_cuda):
        if block is None and layers.dim() == 4 and on_card(layers, "the exact cleanup") \
                and layers.dtype == torch.float32:
            # whole maps on the card: pack, gate, march and update in K2's one launch
            spec = cuda_march.Gate(None, _GATE_SEG, _GATE_BLOCK, _GATE_EPS) if impl == "gated" else None
            out, frac = cuda_march.exact_cleanup(layers, normal, inlier_cnt, assoc.world, assoc.valid,
                                                 t.to(layers.dtype), cfg, spec)
            if not with_aux:
                return out
            return out, (_no_gate_aux(layers) if frac is None else {"gate_survivor_frac": frac})
        pack = exact_precompute(layers, normal, inlier_cnt, cfg)
        gate = exact_gate(pack, cfg, block) if impl == "gated" else None
        res = cuda_march.exact_march(pack, assoc.world, assoc.valid, t.to(pack.dtype), cfg, gate, block)

        lead = layers.shape[:-3]
        out = layers.reshape(*lead, 7, -1).clone()
        out[..., 2, :] -= res.dec
        out[..., 1, :] += res.hits * cfg.outlier_variance
        wrote = torch.isfinite(res.ubmin)
        out[..., 5, :] = torch.where(wrote, res.ubmin, out[..., 5, :])
        out[..., 6, :] = torch.where(wrote, 1.0, out[..., 6, :])
        out = out.reshape(layers.shape)
        if not with_aux:
            return out
        if gate is None:
            return out, _no_gate_aux(layers)
        counts = res.counts if reduce is None else reduce(res.counts)
        surv, total = counts[..., 0], counts[..., 1]
        frac = torch.where(total > 0, surv.to(torch.float32) / torch.clamp(total, min=1).to(torch.float32), 0.0)
        return out, {"gate_survivor_frac": frac.to(layers.dtype)}


class AdaptiveExactRouter:
    """Host-side gated/flat routing for ``raycast_exact_impl="auto"``
    (raycast.py:925-1005, the same policy and backoff).

    Keeps the last gated update's survivor fraction and routes the next
    update to the flat march once it reaches ``threshold`` (the gate then
    culls too little to pay for itself). Flat updates run no gate, so gated
    probes re-measure with exponential backoff: 1, 2, 4, ... flat updates
    between probes, capped at ``probe_period - 1``. A low fraction routes
    straight back to gated.

        router = AdaptiveExactRouter(cfg)
        impl = router.route()                  # "gated" | "flat" | None
        cfg_step = cfg.replace(raycast_exact_impl=impl) if impl else cfg
        state, aux = core.update_pointcloud_aux(..., cfg_step)
        router.observe(impl, aux["gate_survivor_frac"])

    The observed value may stay a device tensor; it is read back at the next
    ``route()``.
    """

    def __init__(self, cfg: MapConfig, threshold: Optional[float] = None, probe_period: Optional[int] = None):
        self.threshold = _GATE_SURV_ROUTE if threshold is None else threshold
        self.probe_period = _GATE_PROBE_PERIOD if probe_period is None else probe_period
        # adaptive only where the exact march runs and impl "auto" resolves
        # to gated
        self._eligible = (
            cfg.raycast_exact_impl == "auto"
            and cfg.enable_visibility_cleanup
            and cfg.n_ray_steps > 0
            and resolve_raycast_mode(cfg) == "exact"
            and cfg.n_ray_steps * cfg.max_points >= _FLAT_MIN_SAMPLES
        )
        self._last_frac = None
        self._flat_streak = 0
        self._flat_budget = 1
        self._probe_pending = False

    def route(self) -> Optional[str]:
        """Implementation for the next update: "gated" or "flat", or None
        when the static resolution stands (routing inactive)."""
        if not self._eligible:
            return None
        frac = None if self._last_frac is None else float(tracing.read_back(torch.as_tensor(self._last_frac)))
        if self._probe_pending:
            # the last gated run was a probe: a confirming one lengthens the
            # flat streak, a refuting one resets it
            self._probe_pending = False
            if frac is not None and frac >= self.threshold:
                self._flat_budget = min(self._flat_budget * 2, max(self.probe_period - 1, 1))
            else:
                self._flat_budget = 1
        if frac is not None and frac >= self.threshold:
            if self._flat_streak < self._flat_budget:
                self._flat_streak += 1
                return "flat"
            self._flat_streak = 0
            self._probe_pending = True
            return "gated"
        return "gated"

    def observe(self, impl: Optional[str], surv_frac) -> None:
        """Record a gated update's survivor fraction (other updates carry
        no gate information)."""
        if impl == "gated":
            self._last_frac = surv_frac


def _bin(x: torch.Tensor, hi: int, rounding: bool = False) -> torch.Tensor:
    """Float -> int32 bin index in [0, hi]: truncation toward zero (or
    round-half-even), clamped first because a cast of an out-of-range float
    is undefined. For in-range values this equals the JAX package's
    clip(cast(x)) (XLA's cast saturates)."""
    x = torch.clamp(x, 0.0, float(hi))
    return (torch.round(x) if rounding else x).to(torch.int32)


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a (B, M, C) table at the (B, Q) indices: (B, Q, C)."""
    return torch.gather(table, 1, idx.long()[:, :, None].expand(-1, -1, table.shape[-1]))


def visibility_cleanup_polar(
    layers: torch.Tensor,
    normal: torch.Tensor,
    assoc: PointAssociation,
    inlier_cnt: torch.Tensor,
    t: torch.Tensor,
    cfg: MapConfig,
    block: Optional[Block] = None,
) -> torch.Tensor:
    """Shadow-cube visibility cleanup (the JAX package's
    ``visibility_cleanup_polar``, raycast.py:1008-1237).

    Rays are binned once into an (azimuth A, radius R, elevation S) cube of
    {count, sum(1/ray_len)} (and, with ``raycast_slope_from_bins=False``, the
    min slope); a suffix scan along R turns it into "rays still active at
    radius >= r", an azimuth prefix sum (and ring min-pyramid) makes the
    azimuth axis range-queryable, and each map cell answers its penetration
    query with a few row gathers plus a reduction over the S elevation
    buckets. The two cube scatter-adds are one 2-stream launch of kernel K1;
    on the card the cube's scans are one call of ``csrc/polar_scan.cu``
    (:func:`polar_scan`) and the per-cell evaluation one launch of
    ``csrc/polar_evaluate.cu`` (:func:`polar_evaluate`).

    A batch of maps (leading axis on every argument) bins all its rays in
    that one launch, each map into its own cube, and the kernel evaluates
    every map in one launch too. On the CPU the evaluation's (cells x S)
    tensors run over at most ``POLAR_EVAL_BYTES`` of them at a time: maps
    beyond that share of the batch are evaluated in later chunks.

    On a ``block`` the cube is built from every ray, as on the whole map,
    and only the block's cells are evaluated, each at its global centre.
    """
    single = layers.dim() == 3
    if single:
        layers, normal, inlier_cnt, t = layers[None], normal[None], inlier_cnt[None], t[None]
        assoc = PointAssociation(*(f[None] for f in assoc))
    if block is None:
        block = Block.whole(cfg.cell_n, cfg.cell_n)
    A = cfg.azimuth_bins
    S = cfg.raycast_elevation_bins
    R = cfg.n_ray_steps + 2
    step = cfg.ray_step
    two_pi = 2.0 * math.pi
    nb = layers.shape[0]

    is_cuda = layers.is_cuda
    with tracing.span("raycast.polar_cube", stream=is_cuda):
        p = assoc.world
        v = p - t[:, None, :]
        len_xy = torch.sqrt(v[..., 0] ** 2 + v[..., 1] ** 2)
        len3d = torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1), min=1e-30))
        phi = torch.atan2(v[..., 2], len_xy)                   # elevation
        az = torch.atan2(v[..., 1], v[..., 0])                 # azimuth [-pi, pi]
        slope = v[..., 2] / torch.clamp(len_xy, min=1e-30)     # tan(phi)

        a_idx = _bin((az + math.pi) * (A / two_pi), A - 1)
        s_idx = _bin((phi + math.pi / 2) * (S / math.pi), S - 1)

        ray_len = torch.clamp(len3d, max=cfg.max_ray_length)
        s_max = torch.minimum(len3d - math.sqrt(0.1), ray_len)  # active span
        r_act = torch.cos(phi) * s_max                        # xy radius bound
        r_idx = _bin(true_div(r_act, step), R - 1, rounding=True)
        active = assoc.valid & (r_act > 0) & (len3d > 0)

        cube_idx = (a_idx * R + r_idx) * S + s_idx            # layout (A, R, S)
        inv_len = 1.0 / torch.clamp(ray_len, min=1e-30)

        cubes = scatter.scatter_add_multi(A * R * S, cube_idx, [torch.ones_like(inv_len), inv_len], active)
        cubes = cubes.reshape(nb, 2, A, R, S)
        use_bins_slope = cfg.raycast_slope_from_bins
        if not use_bins_slope:
            slope_cube = scatter.scatter_min(A * R * S, cube_idx, slope, active, math.inf).reshape(nb, A, R, S)

        pref = polar_scan(cubes)                              # (B, A, R, 2S)
        del cubes
        total = pref[:, -1]                                   # (B, R, 2S)

        # ring min-pyramid over azimuth: level l = window [a, a + 2^l)
        n_levels = min(cfg.raycast_pyramid_levels, max(1, math.ceil(math.log2(A))))
        pyramid = None
        if not use_bins_slope:
            slope_suf = torch.flip(torch.cummin(torch.flip(slope_cube, [2]), dim=2).values, [2])
            levels = [slope_suf]
            for lv in range(1, n_levels + 1):
                prev = levels[-1]
                levels.append(torch.minimum(prev, torch.roll(prev, -(1 << (lv - 1)), dims=1)))
            pyramid = torch.stack(levels, dim=1).reshape(nb, (n_levels + 1) * A * R, S)  # (B, L+1, A, R, S)

    with tracing.span("raycast.polar_evaluate", stream=is_cuda):
        out = polar_evaluate(
            layers, normal, inlier_cnt, t, pref.reshape(nb, A * R, 2 * S), total, pyramid,
            (A, R, S, n_levels, block), cfg,
        )
    return out[0] if single else out


SCAN_KERNEL = CudaKernel(
    "polar_scan.cu", "polar_scan", [ctypes.c_void_p] * 2 + [ctypes.c_int32] * 4 + [ctypes.c_void_p]
)


def polar_scan(cubes: torch.Tensor) -> torch.Tensor:
    """The scans of :func:`visibility_cleanup_polar`'s cube: K1's (B, 2, A,
    R, S) streams (ray counts, sums of 1/length) summed along R from the far
    end ("rays still active at radius >= r"), packed into (B, A, R, 2S)
    (counts, then sums) and summed along A from 0 for range queries.

    A CUDA tensor goes to the kernel (:func:`launch_polar_scan`), one
    launch for the whole batch; a CPU tensor to :func:`_polar_scan`."""
    if on_card(cubes, "the polar cube's scans"):
        return launch_polar_scan(cubes)
    return _polar_scan(cubes)


def _check_scan(cubes: torch.Tensor) -> None:
    """Refuses a cube that neither version of the scans takes."""
    if cubes.dim() != 5 or cubes.shape[1] != 2:
        raise ValueError(f"the polar cube must be (B, 2, A, R, S); got {tuple(cubes.shape)}")
    if cubes.dtype != torch.float32:
        raise TypeError(f"the polar cube must be float32; got {cubes.dtype}")


def launch_polar_scan(cubes: torch.Tensor) -> torch.Tensor:
    """:func:`polar_scan` as one call of ``csrc/polar_scan.cu`` on the
    current stream (two passes: along R, then along A in place). Takes a
    contiguous float32 cube; refuses anything else, and a cube not on a
    card, before the kernel is built."""
    _check_scan(cubes)
    if not cubes.is_contiguous():
        raise ValueError("the polar scan kernel needs a contiguous cube")
    nb, _, A, R, S = cubes.shape
    pref = torch.empty((nb, A, R, 2 * S), dtype=cubes.dtype, device=cubes.device)
    if pref.numel() == 0:
        return pref
    SCAN_KERNEL.launch(cubes.device, cubes.data_ptr(), pref.data_ptr(), nb, A, R, S)
    return pref


def _polar_scan(cubes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`polar_scan`, which the tests hold to
    the JAX package and the kernel to on the card."""
    _check_scan(cubes)
    # suffix scans along R: "rays with r_act >= r", cnt and inv packed into
    # one (B, A, R, 2S) tensor
    packed = torch.cat([torch.flip(torch.cumsum(torch.flip(cubes[:, i], [2]), dim=2), [2]) for i in range(2)],
                       dim=-1)
    # azimuth prefix for range sums
    return torch.cumsum(packed, dim=1)


# bytes of one (maps x cells x S) float32 tensor of the plain per-cell
# evaluation: on the CPU a batch larger than this evaluates in chunks of maps
POLAR_EVAL_BYTES = 1 << 29

KERNEL = CudaKernel(
    "polar_evaluate.cu",
    "polar_evaluate",
    [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 2 + [ctypes.c_int32] * 10
    + [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p],
)


def polar_evaluate(layers, normal, inlier_cnt, t, pref_flat, total, pyramid, geo, cfg) -> torch.Tensor:
    """The per-cell half of :func:`visibility_cleanup_polar` for a batch
    of maps (B, 7, h, w): each cell's azimuth-window query of the prefix
    cube ``pref_flat`` (B, A*R, 2S) and its row of ``total`` (B, R, 2S), of
    the min-slope ``pyramid`` (B, (L+1)*A*R, S) if there is one, the
    penetration test over the S buckets, and the layer updates. ``geo`` is
    (A, R, S, L, block).

    A CUDA tensor goes to the kernel (:func:`launch_polar_evaluate`), one
    launch for the whole batch; a CPU tensor to :func:`_polar_evaluate`, in
    chunks of at most ``POLAR_EVAL_BYTES`` of (maps x cells x S)."""
    if on_card(layers, "the polar evaluation"):
        return launch_polar_evaluate(
            layers.contiguous(), normal.contiguous(), inlier_cnt, t.contiguous(), pref_flat, total, pyramid, geo, cfg
        )
    return _polar_evaluate_in_chunks(layers, normal, inlier_cnt, t, pref_flat, total, pyramid, geo, cfg)


def _polar_evaluate_in_chunks(layers, normal, inlier_cnt, t, pref_flat, total, pyramid, geo, cfg) -> torch.Tensor:
    """:func:`_polar_evaluate` over at most ``POLAR_EVAL_BYTES`` of (maps x
    cells x S) at a time, on any device (the card's tests and smoke run hold
    the kernel to it there)."""
    nb = layers.shape[0]
    block = geo[4]
    chunk = max(1, min(nb, POLAR_EVAL_BYTES // max(1, block.h * block.w * geo[2] * layers.element_size())))
    if chunk >= nb:
        return _polar_evaluate(layers, normal, inlier_cnt, t, pref_flat, total, pyramid, geo, cfg)
    return torch.cat([
        _polar_evaluate(
            layers[b0:b0 + chunk], normal[b0:b0 + chunk], inlier_cnt[b0:b0 + chunk], t[b0:b0 + chunk],
            pref_flat[b0:b0 + chunk], total[b0:b0 + chunk],
            None if pyramid is None else pyramid[b0:b0 + chunk], geo, cfg,
        )
        for b0 in range(0, nb, chunk)
    ])


def _check_evaluate(layers, normal, inlier_cnt, t, pref_flat, total, pyramid, geo, cfg) -> None:
    """Refuses shapes that neither version of the evaluation takes."""
    A, R, S, n_levels, block = geo
    if layers.dim() != 4 or layers.shape[1] != 7:
        raise ValueError(f"the layers must be (B, 7, h, w); got {tuple(layers.shape)}")
    nb, _, h, w = layers.shape
    want = {"normal": (normal, (nb, 3, h, w)), "inlier_cnt": (inlier_cnt, (nb, h, w)), "t": (t, (nb, 3)),
            "pref_flat": (pref_flat, (nb, A * R, 2 * S)), "total": (total, (nb, R, 2 * S))}
    if pyramid is not None:
        want["pyramid"] = (pyramid, (nb, (n_levels + 1) * A * R, S))
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape} for these layers and cube; got {tuple(x.shape)}")
    n = cfg.cell_n
    if ((block.h, block.w) != (h, w) or (block.gh, block.gw) != (n, n) or block.r0 < 0 or block.c0 < 0
            or block.r0 + h > n or block.c0 + w > n):
        raise ValueError(f"{block} does not place {h}x{w} layers in the {n}x{n} map")


def _maps_contiguous(x: torch.Tensor) -> bool:
    """Whether each map (the leading axis) of ``x`` is contiguous."""
    return x[0].is_contiguous() if x.shape[0] else True


def launch_polar_evaluate(layers, normal, inlier_cnt, t, pref_flat, total, pyramid, geo, cfg) -> torch.Tensor:
    """:func:`polar_evaluate` as one launch of ``csrc/polar_evaluate.cu`` on
    the current stream. Takes float32 tensors: contiguous layers, normals,
    t, cube and pyramid, and ``inlier_cnt`` and ``total`` whose maps are
    each contiguous; refuses anything else, and any tensor not on a card,
    before the kernel is built."""
    A, R, S, n_levels, block = geo
    _check_evaluate(layers, normal, inlier_cnt, t, pref_flat, total, pyramid, geo, cfg)
    tensors = [layers, normal, inlier_cnt, t, pref_flat, total] + ([] if pyramid is None else [pyramid])
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError(f"the polar evaluation kernel takes float32 tensors; got {[x.dtype for x in tensors]}")
    whole = [layers, normal, t, pref_flat] + ([] if pyramid is None else [pyramid])
    if not all(x.is_contiguous() for x in whole) or not all(_maps_contiguous(x) for x in (inlier_cnt, total)):
        raise ValueError("the polar evaluation kernel needs contiguous tensors (inlier_cnt and total: each map)")
    if any(x.device != layers.device for x in tensors):
        raise ValueError("the layers, normals, counts, cube and pyramid must lie on one device")
    out = torch.empty_like(layers)
    if out.numel() == 0:
        return out
    table = _bucket_table(S, cfg.ray_step, cfg.resolution, torch.float32, layers.device)
    consts = _kernel_constants(cfg, A)
    KERNEL.launch(
        layers.device, layers.data_ptr(), normal.data_ptr(), inlier_cnt.data_ptr(), t.data_ptr(),
        pref_flat.data_ptr(), total.data_ptr(), None if pyramid is None else pyramid.data_ptr(), table.data_ptr(),
        out.data_ptr(), inlier_cnt.stride(0), total.stride(0), layers.shape[0], block.h, block.w, block.r0, block.c0,
        cfg.cell_n, A, R, S, n_levels, (ctypes.c_float * len(consts))(*consts), len(consts),
    )
    return out


def _kernel_constants(cfg: MapConfig, A: int) -> tuple:
    """The Python scalars that :func:`_polar_evaluate` hands to torch ops,
    which cast them to float32, in the order of the kernel's ``Const``."""
    step = cfg.ray_step
    return (
        0.5 * cfg.cell_n, cfg.resolution, math.pi, A / (2.0 * math.pi), step, cfg.max_ray_length, step * 0.5,
        1e-6, 1e-9, cfg.resolution**2, 0.01, 0.05, cfg.cleanup_cos_thresh, cfg.wall_num_thresh,
        cfg.cleanup_step * cfg.max_ray_length, cfg.outlier_variance,
    )


@functools.lru_cache(maxsize=16)
def _bucket_table(S: int, step: float, resolution: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(5, S) per elevation bucket, from the config alone: tan, cos and sin
    of the bucket's centre angle (float32 angles, as the JAX package
    computes them), the xy sample spacing ``delta`` and the saturated
    acceptance width ``res^2 / delta``."""
    phi_k = (torch.arange(S, dtype=dtype, device=device) + 0.5) * (math.pi / S) - math.pi / 2
    cos_pk = torch.cos(phi_k)
    delta_k = step * cos_pk
    w_sat = (resolution**2) / torch.clamp(delta_k, min=1e-9)
    return torch.stack([torch.tan(phi_k), cos_pk, torch.sin(phi_k), delta_k, w_sat])


def _polar_evaluate(layers, normal, inlier_cnt, t, pref_flat, total, pyramid, geo, cfg) -> torch.Tensor:
    """Plain PyTorch version of :func:`polar_evaluate`, which the tests hold
    to the JAX package and the kernel to on the card."""
    _check_evaluate(layers, normal, inlier_cnt, t, pref_flat, total, pyramid, geo, cfg)
    A, R, S, n_levels, block = geo
    n = cfg.cell_n
    step = cfg.ray_step
    dt = layers.dtype
    dev = layers.device
    two_pi = 2.0 * math.pi
    tx, ty, tz = (t[:, i, None] for i in range(3))

    i = torch.arange(block.h * block.w, dtype=torch.int32, device=dev)
    row_i = block.r0 + i // block.w
    col_i = block.c0 + i % block.w
    cx = (row_i.to(dt) + 0.5 - 0.5 * n) * cfg.resolution - tx
    cy = (col_i.to(dt) + 0.5 - 0.5 * n) * cfg.resolution - ty
    r_c = torch.sqrt(cx * cx + cy * cy)
    a_c = torch.atan2(cy, cx)
    ai = _bin((a_c + math.pi) * (A / two_pi), A - 1)
    ri = _bin(true_div(r_c, step), R - 1, rounding=True)
    in_range = (r_c <= cfg.max_ray_length) & (r_c >= step * 0.5)

    # azimuth half-window = the cell's crossing band for rays at this azimuth
    abs_c = torch.abs(torch.cos(a_c))
    abs_s = torch.abs(torch.sin(a_c))
    band = cfg.resolution * (abs_c + abs_s)
    half_ang = torch.atan2(0.5 * band, torch.clamp(r_c, min=1e-6))
    hw = _bin(half_ang * (A / two_pi), A // 2 - 1)
    lo = ai - hw
    hi = ai + hw
    width = 2 * hw + 1

    # single-row gathers at the joint (azimuth, radius) index
    hi_rows = _rows(pref_flat, (hi % A) * R + ri)
    lo_rows0 = _rows(pref_flat, ((lo - 1) % A) * R + ri)
    zero_lo = (lo % A) == 0
    lo_rows = torch.where(zero_lo[..., None], 0.0, lo_rows0)
    tot_rows = _rows(total, ri)
    wrapped = (lo % A) > (hi % A)
    sums_rows = torch.where(wrapped[..., None], tot_rows - (lo_rows - hi_rows), hi_rows - lo_rows)
    del hi_rows, lo_rows0, lo_rows, tot_rows  # the largest temporaries: (B, n*n, 2S)
    cnt_k = sums_rows[..., :S]
    inv_k = sums_rows[..., S:]

    if pyramid is not None:
        # windowed min query: level l = ceil(log2(width)); two windows cover it
        lvl = torch.clamp(torch.ceil(torch.log2(width.to(dt))), 0, n_levels).to(torch.int32)
        start1 = lo % A
        start2 = (lo + width - (torch.ones_like(lvl) << lvl)) % A
        m1 = _rows(pyramid, (lvl * A + start1) * R + ri)
        m2 = _rows(pyramid, (lvl * A + start2) * R + ri)
        slope_k_min = torch.minimum(m1, m2)               # (B, n*n, S)

    flatL = layers.flatten(-2)
    cell_h = flatL[:, 0]
    cell_v = flatL[:, 1]
    cell_valid = flatL[:, 2]
    cell_t = flatL[:, 4]
    cell_ub = flatL[:, 5]
    cell_iub = flatL[:, 6]
    nrm = normal.flatten(-2)
    ic = inlier_cnt.flatten(-2)

    inside = (row_i > 0) & (row_i < n - 1) & (col_i > 0) & (col_i < n - 1)

    tan_k, cos_pk, sin_pk, delta_k, w_sat = _bucket_table(S, cfg.ray_step, cfg.resolution, dt, dev)

    safe_r = torch.clamp(r_c, min=1e-6)

    # the exact march evaluates each cell at its entry sample, not its
    # center: expected evaluation radius is r_c minus half the mean chord
    # (res^2 / band) plus half the xy sample spacing delta_k
    mean_chord = cfg.resolution**2 / torch.clamp(band, min=1e-9)
    r_eval = torch.clamp(
        safe_r[..., None] - 0.5 * mean_chord[..., None] + 0.5 * delta_k, min=1e-6
    )                                                     # (B, n*n, S)

    s_star_num = cell_h - 0.01 + torch.clamp(cell_v, max=1.0) * 0.05 - tz
    pen_k = tan_k * r_eval < s_star_num[..., None]

    g_c = torch.cos(a_c) * nrm[:, 0] + torch.sin(a_c) * nrm[:, 1]
    dot_k = torch.abs(g_c[..., None] * cos_pk + nrm[:, 2, :, None] * sin_pk)
    cos_ok = dot_k >= cfg.cleanup_cos_thresh

    # sampling-acceptance correction: P(hit | chord l) = min(1, l / delta)
    # integrated over the chord profile of a square cell
    mx = torch.maximum(abs_c, abs_s)
    w_lin = band[..., None] - delta_k * (abs_c * abs_s)[..., None]
    use_sat = delta_k >= (cfg.resolution / torch.clamp(mx, min=1e-9))[..., None]
    w_eff = torch.where(use_sat, w_sat, w_lin)
    accept_k = torch.clamp(w_eff / torch.clamp(band[..., None], min=1e-9), 0.0, 1.0)

    has_rays = cnt_k > 0.5
    is_invalid = cell_valid < 0.5
    not_recent = cell_t >= 0.5
    wall_skip = (ic > cfg.wall_num_thresh) & (cell_t < 1.0)
    cell_gate = in_range & inside & ~is_invalid & not_recent & ~wall_skip

    hit_k = has_rays & pen_k & cos_ok & cell_gate[..., None]
    dec = cfg.cleanup_step * cfg.max_ray_length * torch.sum(
        torch.where(hit_k, inv_k * accept_k, 0.0), dim=-1
    )
    var = cfg.outlier_variance * torch.sum(torch.where(hit_k, cnt_k * accept_k, 0.0), dim=-1)

    # upper-bound candidates: min ray height per bucket at the eval radius
    if pyramid is None:
        nz_k = tz[..., None] + r_eval * tan_k
    else:
        nz_k = tz[..., None] + r_eval * slope_k_min
    ub_cond_k = (cell_iub[..., None] < 0.5) | (nz_k < cell_ub[..., None])
    candA = (in_range & inside & is_invalid)[..., None] & has_rays & ub_cond_k
    candB = hit_k & ub_cond_k
    cand = candA | candB
    ubmin = torch.amin(torch.where(cand, nz_k, math.inf), dim=-1)
    wrote = torch.isfinite(ubmin)

    out = flatL.clone()
    out[:, 2] -= dec.to(dt)
    out[:, 1] += var.to(dt)
    out[:, 5] = torch.where(wrote, ubmin.to(dt), out[:, 5])
    out[:, 6] = torch.where(wrote, 1.0, out[:, 6])
    return out.reshape(layers.shape)
