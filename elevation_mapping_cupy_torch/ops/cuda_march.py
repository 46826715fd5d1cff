"""K2 ``exact_march``: the exact visibility-cleanup ray march as one kernel.

Counterpart of the march loops of ``elevation_mapping_cupy_tpu/ops/raycast.py``
(``_exact_scan``, ``_exact_flat``, ``_exact_gated``) and of the in-kernel
gather, scatter-add, scatter-min and sort that
``scripts/probe_pallas_gather.py`` probed for them on the TPU. The CUDA
kernel is ``csrc/exact_march.cu``; its source note gives the design and the
bound. :func:`exact_march` launches it for CUDA tensors and raises if it
cannot; for CPU tensors it runs :func:`exact_march_reference`, the plain
PyTorch version (the scan's step loop), which the tests hold to the JAX
package.

Inputs, built by ``ops/raycast.py``:

- ``pack`` (h*w, 8) float32 cell rows of the R1 snapshot: height,
  penetration slack ``min(var, 1) * 0.05``, upper-bound threshold (+inf
  without an upper bound), code (1 invalid, 2 eligible to be cleaned up,
  0 neither), normal x, y, z, and a zero pad; the cells are a ``block``
  (``geometry.Block``) of the map, by default the whole map;
- ``world`` (N, 3) ray end points and ``valid`` (N,) bool (a ray that is not
  valid is not marched), both in the map-center frame;
- ``t`` (3,) sensor position in the map-center frame;
- ``gate``: optional :class:`Gate`.

A leading batch axis of B maps may come first on each (``pack`` (B, h*w, 8),
``world`` (B, N, 3), ``valid`` (B, N), ``t`` (B, 3), the gate's ``table``
(B, rows, cols)): map b's rays then march on map b's cells, and every output
has the same axis. The kernel marches the whole batch in one launch.

Each ray's direction, decrement and live-step count come from ``world`` and
``t`` (:func:`ray_table`); step m samples the ray at
``s_m = (m + 1) * ray_step``.

Outputs (:class:`MarchResult`): per cell of the block the summed
decrement, the number of hits (an integer in float32), the lowest
upper-bound candidate (+inf where none was written) and, with a gate, the
surviving and live segment counts (int64), one pair per map.

On a block every sample is computed as on the whole map, in the same
global cell, and writes only when that cell lies in the block: the blocks'
outputs put together are the whole map's.

:func:`exact_cleanup` is the same launch given the map's layers instead of
the pack: the kernel then builds the pack and the gate table itself and
writes the new layers, so the whole exact cleanup of whole maps on the card
is one call (``ops/raycast.py::visibility_cleanup_exact`` composes the same
steps from its plain parts elsewhere).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..config import MapConfig
from ..kernels import CudaKernel, on_card
from .geometry import Block, cell_indices, fma32, is_inside, sqrt32, true_div

__all__ = [
    "KERNEL",
    "PACK_WIDTH",
    "Gate",
    "MarchResult",
    "exact_march",
    "exact_march_reference",
    "exact_cleanup",
    "ray_steps",
    "ray_table",
    "steps_below",
]

KERNEL = CudaKernel(
    "exact_march.cu",
    "exact_march",
    [ctypes.c_void_p] * 6
    + [ctypes.c_int32, ctypes.c_int64] + [ctypes.c_int32] * 5
    + [ctypes.c_float, ctypes.c_float, ctypes.c_int32, ctypes.c_float, ctypes.c_float, ctypes.c_float]
    + [ctypes.c_int32] * 6 + [ctypes.c_float, ctypes.c_int32]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_float]
    + [ctypes.c_void_p],
)

# lanes of a warp that march one ray together (16 or 32), without and with
# a gate: a gated ray has only its surviving segments' few steps to spread
# over them
LANES_FLAT = 32
LANES_GATED = 16

# floats per cell row of the pack: seven values and a pad, so that the
# kernel reads a row as two 16-byte loads
PACK_WIDTH = 8
# sqrt(float32(0.1)) rounded once to float32 (a float64 root rounded to
# float32 is the correctly rounded float32 root): the endpoint test's reach
_ROOT_01 = math.sqrt(float(torch.tensor(0.1, dtype=torch.float32)))


class Gate(NamedTuple):
    """Segment gate of the gated march: ``table`` (rows, cols) float32
    holds, per gate block of ``block`` x ``block`` cells, the 3x3-dilated
    block max of the cell write threshold, for the gate blocks from
    ``origin`` (row, column); a segment of ``seg`` steps whose lowest sample
    is not below ``table + eps`` at the gate block of its first sample, or
    whose first sample's gate block lies outside the table, holds no writer
    and is skipped."""

    table: torch.Tensor                    # (rows, cols), or (B, rows, cols)
    seg: int
    block: int
    eps: float
    origin: Tuple[int, int] = (0, 0)


class MarchResult(NamedTuple):
    """Per cell of the block, with the inputs' batch axis in front."""

    dec: torch.Tensor                      # (h*w,) float32 summed decrement
    hits: torch.Tensor                     # (h*w,) float32 hit count
    ubmin: torch.Tensor                    # (h*w,) float32, +inf where unwritten
    counts: Optional[torch.Tensor] = None  # (2,) int64 [surviving, live] segments


def ray_steps(cfg: MapConfig, device) -> torch.Tensor:
    """(n_ray_steps,) float32 sample distances ``(m + 1) * ray_step``,
    rounded as the JAX package rounds them."""
    step = torch.tensor(cfg.ray_step, dtype=torch.float32, device=device)
    return torch.arange(1, cfg.n_ray_steps + 1, dtype=torch.float32, device=device) * step


def steps_below(x: torch.Tensor, inclusive: bool, step: float, n_steps: int) -> torch.Tensor:
    """Steps m in [0, n_steps) with ``s_m < x`` (``s_m <= x`` when
    ``inclusive``), ``s_m = float32((m + 1) * step)``, for float32 ``x``
    without NaN: K2's closed-form step count (csrc/exact_march.cu,
    ``steps_below``), mirrored here so that the CPU tests can hold it to
    ``torch.searchsorted`` over :func:`ray_steps` (side "left", or "right"
    when inclusive). The first guess is the quotient ``x / step``; single
    steps up, then down, move it until ``s_{c-1}`` is below x and ``s_c`` is
    not. s_m grows with m, so that count is unique."""
    step32 = torch.tensor(step, dtype=torch.float32, device=x.device)

    def below(c):  # s_{c-1} = fl(c * step) is below x
        s = c.to(torch.float32) * step32
        return (s <= x) if inclusive else (s < x)

    c = torch.clamp(x / step32, min=0.0, max=float(n_steps)).to(torch.int64)
    while True:
        up = (c < n_steps) & below(c + 1)
        if not bool(up.any()):
            break
        c = c + up.to(torch.int64)
    while True:
        down = (c > 0) & ~below(c)
        if not bool(down.any()):
            break
        c = c - down.to(torch.int64)
    return c


def _fma(a, b, c):
    """a * b + c rounded as XLA:CPU rounds it for float32; other dtypes
    (the scan's float64 maps) are not held to the JAX package's bits."""
    return fma32(a, b, c) if a.dtype == torch.float32 else a * b + c


def ray_table(
    world: torch.Tensor, valid: torch.Tensor, t: torch.Tensor, cfg: MapConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version's per-ray table (7, N) (direction, end point,
    decrement) and live-step count k (N,) int32, as ``_exact_flat`` builds
    them (raycast.py:382-400); K2 computes the same per thread.

    k counts the steps with ``s_m < ray_length`` and
    ``s_m <= norm - sqrt(0.1) + step`` (past which the endpoint test
    ``d >= 0.1`` rejects every sample, so the cut changes no result) by the
    same float32 compares as the JAX package (``searchsorted`` over the same
    steps vector, same sides). Rays that are not valid get k = 0."""
    dt = world.dtype
    v = world - t
    # jnp.linalg.norm as XLA:CPU compiles it: a reduction of fused
    # multiply-adds and a correctly rounded root
    sq = v[:, 0] * v[:, 0]
    if dt == torch.float32:
        norm = sqrt32(fma32(v[:, 2], v[:, 2], fma32(v[:, 1], v[:, 1], sq)))
    else:  # the scan's other dtypes are not held to the JAX package's bits
        norm = torch.sqrt(v[:, 2] * v[:, 2] + (v[:, 1] * v[:, 1] + sq))
    rdir = torch.where(norm[:, None] > 0, v / torch.clamp(norm, min=1e-30)[:, None], 0.0)
    ray_length = torch.clamp(norm, max=cfg.max_ray_length)
    dec_amount = torch.full_like(ray_length, cfg.cleanup_step) / true_div(ray_length, cfg.max_ray_length)
    steps = ray_steps(cfg, world.device).to(dt)
    step = torch.tensor(cfg.ray_step, dtype=dt, device=world.device)
    end = norm - torch.tensor(_ROOT_01, dtype=dt, device=world.device) + step
    k = torch.minimum(
        torch.searchsorted(steps, ray_length.contiguous(), side="left"),
        torch.searchsorted(steps, end.contiguous(), side="right"),
    )
    k = torch.where(valid, k, 0).to(torch.int32)
    rays = torch.stack([rdir[:, 0], rdir[:, 1], rdir[:, 2], world[:, 0], world[:, 1], world[:, 2], dec_amount])
    return rays, k


def _block(cfg: MapConfig, block: Optional[Block]) -> Block:
    n = cfg.cell_n
    if block is None:
        return Block.whole(n, n)
    if (block.gh, block.gw) != (n, n) or min(block.r0, block.c0) < 0 or block.h <= 0 or block.w <= 0 \
            or block.r0 + block.h > n or block.c0 + block.w > n:
        raise ValueError(f"block {block} does not lie in the {n} x {n} map")
    return block


def _check(pack, world, valid, t, cfg: MapConfig, gate: Optional[Gate], block: Block) -> None:
    n2 = block.h * block.w
    lead = tuple(pack.shape[:-2])
    if pack.dim() not in (2, 3) or tuple(pack.shape[-2:]) != (n2, PACK_WIDTH):
        raise ValueError(f"pack must be ({n2}, {PACK_WIDTH}) with at most a batch axis; got {tuple(pack.shape)}")
    if world.shape[:-2] != lead or world.shape[-1:] != (3,) or valid.shape != world.shape[:-1]:
        raise ValueError(f"world must be {lead + ('N', 3)} and valid {lead + ('N',)}; "
                         f"got {tuple(world.shape)} and {tuple(valid.shape)}")
    if t.shape != lead + (3,):
        raise ValueError(f"t must be {lead + (3,)}; got {tuple(t.shape)}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool; got {valid.dtype}")
    tensors = [pack, world, valid, t] + ([gate.table] if gate is not None else [])
    if len({x.device for x in tensors}) != 1:
        raise ValueError("the march's tensors must lie on one device")
    if gate is not None and (gate.table.shape[:-2] != lead or gate.table.dim() != 2 + len(lead)
                             or min(gate.origin) < 0):
        raise ValueError(f"gate table must be {lead + ('rows', 'cols')} from an origin >= 0; "
                         f"got {tuple(gate.table.shape)} at {gate.origin}")


def _batched(pack, world, valid, t, gate: Optional[Gate]):
    """The inputs with a batch axis (one map gets one), and whether they
    came without."""
    if pack.dim() == 3:
        return pack, world, valid, t, gate, False
    gate = None if gate is None else gate._replace(table=gate.table[None])
    return pack[None], world[None], valid[None], t[None], gate, True


def _unbatched(res: MarchResult, single: bool) -> MarchResult:
    return MarchResult(*(None if x is None else x[0] for x in res)) if single else res


def _segment_survives(rays, m0: int, m1, t, maps, gate: Gate, steps, cfg: MapConfig) -> torch.Tensor:
    """Gate test of the segments [m0, m1) of the rays ``rays`` (7, L)
    (``m1`` (L,) exclusive ends) from ``t`` (3, L) on the maps ``maps`` (L,)
    of the batched table: True where the segment may hold a writer
    (``_exact_gated``'s test, raycast.py:801-810)."""
    s_lo = steps[m0]
    s_hi = steps[(m1 - 1).long()]
    xy0 = torch.stack([_fma(rays[0], s_lo, t[0]), _fma(rays[1], s_lo, t[1])], dim=-1)
    nz_min = torch.minimum(_fma(rays[2], s_lo, t[2]), _fma(rays[2], s_hi, t[2]))
    ix, iy = cell_indices(xy0, torch.zeros(2, dtype=rays.dtype, device=rays.device), cfg)
    rows, cols = gate.table.shape[-2:]
    bx = ix // gate.block - gate.origin[0]
    by = iy // gate.block - gate.origin[1]
    held = (bx >= 0) & (bx < rows) & (by >= 0) & (by < cols)
    g = gate.table.reshape(-1)[torch.where(held, (maps * rows + bx) * cols + by, 0).long()]
    return held & (nz_min < g + gate.eps)


def _tally(work: Optional[Dict[str, int]], **counts) -> None:
    if work is not None:
        for key, c in counts.items():
            work[key] = work.get(key, 0) + int(c)


def exact_march_reference(
    pack: torch.Tensor,
    world: torch.Tensor,
    valid: torch.Tensor,
    t: torch.Tensor,
    cfg: MapConfig,
    gate: Optional[Gate] = None,
    work: Optional[Dict[str, int]] = None,
    block: Optional[Block] = None,
) -> MarchResult:
    """Plain PyTorch version: the step loop of ``_exact_scan``
    (raycast.py:257-312) over the rays still live at each step, with the
    segment gate of ``_exact_gated`` applied at each segment's first step
    when a gate is given. Per-sample arithmetic is the JAX package's as XLA
    compiles it on the CPU, FMAs included (:func:`fma32`); only the order of
    the decrement's additions differs.

    A batch marches every map's rays together, each on its own map's
    cells; per map the result is that map's march alone, bit for bit (a
    cell's decrement adds its rays in the same order).

    ``work``, when given, gets the number of valid rays and tested segments,
    and of samples at each rule the march applies: walked (every sample of
    a ray's live steps, or of the segments that pass the gate), fresh (in
    the map and in a cell the previous step was not in), tested (past the
    endpoint test, so the cell row is read), eligible (on a cell that can
    be cleaned up), penetrating, hits and upper-bound writes, summed over
    the maps. A bound on the kernel's time is counted from these; on a
    block, "fresh" counts only the samples in the block."""
    block = _block(cfg, block)
    _check(pack, world, valid, t, cfg, gate, block)
    pack, world, valid, t, gate, single = _batched(pack, world, valid, t, gate)
    n = cfg.cell_n
    dev, dt = pack.device, pack.dtype
    b, n_rays = world.shape[:2]
    n2 = block.h * block.w
    dec = torch.zeros(b * n2, dtype=dt, device=dev)
    hits = torch.zeros(b * n2, dtype=dt, device=dev)
    ubmin = torch.full((b * n2,), math.inf, dtype=dt, device=dev)
    counts = torch.zeros(b * 2, dtype=torch.int64, device=dev) if gate is not None else None

    def result():
        return _unbatched(MarchResult(dec.view(b, n2), hits.view(b, n2), ubmin.view(b, n2),
                                      None if counts is None else counts.view(b, 2)), single)

    _tally(work, rays=valid.sum() if valid.numel() else 0)
    if valid.numel() == 0:
        return result()
    # every map's rays in one list, each with its map and sensor position
    maps = torch.arange(b, device=dev).repeat_interleave(n_rays)
    t_ray = t[maps]
    rays, k = ray_table(world.reshape(-1, 3), valid.reshape(-1), t_ray, cfg)
    k_max = int(k.max())
    if k_max == 0:
        return result()

    # longest rays first: the rays live at step m are then a prefix (a
    # stable sort keeps each map's rays in their order)
    order = torch.argsort(k, descending=True, stable=True)
    ks = k[order].long()
    rr = rays[:, order]
    tt = t_ray[order].T
    mo = maps[order]
    ended = torch.cumsum(torch.bincount(ks, minlength=k_max + 1), 0)
    n_live = (b * n_rays - ended[:k_max]).tolist()   # rays with k > m, per step m
    steps = ray_steps(cfg, dev).to(dt)
    zero2 = torch.zeros(2, dtype=dt, device=dev)
    pack = pack.reshape(b * n2, PACK_WIDTH)

    def position(axis, s, live):
        return _fma(rr[axis, :live], s, tt[axis, :live])

    def cells(s, live):
        xy = torch.stack([position(0, s, live), position(1, s, live)], dim=-1)
        ix, iy = cell_indices(xy, zero2, cfg)
        return n * ix + iy, ix, iy

    survive = None
    for m in range(k_max):
        live = n_live[m]
        if gate is not None and m % gate.seg == 0:
            m1 = torch.clamp(ks[:live], max=m + gate.seg)
            survive = _segment_survives(rr[:, :live], m, m1, tt[:, :live], mo[:live], gate, steps, cfg)
            counts[1::2] += torch.bincount(mo[:live], minlength=b)
            counts[0::2] += torch.bincount(mo[:live][survive], minlength=b)
            _tally(work, segments=live)
        s = steps[m]
        nidx, ix, iy = cells(s, live)
        local, held = block.localize(ix, iy)
        fresh = is_inside(ix, iy, cfg) & held
        if m > 0:
            fresh &= nidx != cells(steps[m - 1], live)[0]
        if survive is not None:
            fresh &= survive[:live]
        nz = position(2, s, live)
        ex = rr[3, :live] - position(0, s, live)
        ey = rr[4, :live] - position(1, s, live)
        ez = rr[5, :live] - nz
        active = fresh & (_fma(ez, ez, _fma(ey, ey, ex * ex)) >= 0.1)
        _tally(work, walked=live if survive is None else survive[:live].sum(), fresh=fresh.sum())
        sel = torch.nonzero(active).squeeze(1)
        if sel.numel() == 0:
            continue
        cell = mo[sel] * n2 + local[sel].long()
        nz = nz[sel]
        row = pack[cell]
        ub_cond = nz < row[:, 2]
        eligible = row[:, 3] == 2.0
        penet = row[:, 0] > nz + 0.01 - row[:, 1]
        product = _fma(rr[2, sel], row[:, 6], _fma(rr[0, sel], row[:, 4], rr[1, sel] * row[:, 5]))
        hit = eligible & penet & (torch.abs(product) >= cfg.cleanup_cos_thresh)
        write_ub = ((row[:, 3] == 1.0) | hit) & ub_cond
        _tally(work, tested=sel.numel(), eligible=eligible.sum(), penetrating=(eligible & penet).sum(),
               hits=hit.sum(), ub_writes=write_ub.sum())
        dec.index_add_(0, cell[hit], rr[6, sel][hit])
        hits.index_add_(0, cell[hit], torch.ones_like(nz[hit]))
        ubmin.scatter_reduce_(0, cell[write_ub], nz[write_ub], reduce="amin")
    return result()


def exact_march(
    pack: torch.Tensor,
    world: torch.Tensor,
    valid: torch.Tensor,
    t: torch.Tensor,
    cfg: MapConfig,
    gate: Optional[Gate] = None,
    block: Optional[Block] = None,
) -> MarchResult:
    """The exact march: see :func:`exact_march_reference` for the contract.
    CUDA tensors go to the kernel, one launch for every map of a batch; CPU
    tensors to the plain version. From the kernel, ``dec`` and ``hits`` are
    the two columns of one (..., h*w, 2) buffer, views of stride 2;
    ``ubmin`` and ``counts`` are views of the same allocation. The plain
    version returns contiguous tensors."""
    block = _block(cfg, block)
    _check(pack, world, valid, t, cfg, gate, block)
    if not on_card(pack, "exact_march"):
        return exact_march_reference(pack, world, valid, t, cfg, gate, block=block)
    tensors = [pack, world, t] + ([gate.table] if gate is not None else [])
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError("exact_march's kernel takes float32 pack, world, t and gate table")
    pack, world, valid, t, gate, single = _batched(pack, world, valid, t, gate)
    b, n2 = world.shape[0], block.h * block.w
    pack, world, valid, t = (x.contiguous() for x in (pack, world, valid, t))
    if gate is not None:
        gate = gate._replace(table=gate.table.contiguous())
    buf = _launch(pack, world, valid, t, cfg, gate, block)
    dechits = buf[:, 4 : 4 + 2 * n2].view(b, n2, 2)
    counts = buf[:, :4].view(torch.int64) if gate is not None else None
    res = MarchResult(dechits[..., 0], dechits[..., 1], buf[:, 4 + 2 * n2 : 4 + 3 * n2], counts)
    return _unbatched(res, single)


def _launch(pack, world, valid, t, cfg: MapConfig, gate: Optional[Gate], block: Block, snapshot=()) -> torch.Tensor:
    """One launch of K2 over batched, contiguous float32 inputs (none when
    there is nothing to march, which a whole cleanup never asks); returns
    its outputs' buffer. ``snapshot``,
    when given, is the entry point's (layers, normal, inlier, inlier's map
    stride, new layers, survivor fractions) for a whole cleanup."""
    b, n_rays = world.shape[:2]
    n2 = block.h * block.w
    gate_ptr, seg, gblock, gate_r0, gate_c0, rows, cols, eps = None, 0, 0, 0, 0, 0, 0, 0.0
    if gate is not None:
        gate_ptr = gate.table.data_ptr()
        seg, gblock, eps = gate.seg, gate.block, gate.eps
        (gate_r0, gate_c0), (rows, cols) = gate.origin, gate.table.shape[-2:]
    # one buffer for every output, initialised by the entry point on the
    # stream: per map 4 floats that hold the two int64 counts, the (h*w, 2)
    # decrement and hit count (one float2 atomic adds both), the upper bound,
    # and h*w of the kernel's scratch
    buf = torch.empty((b, 4 + 4 * n2), dtype=torch.float32, device=pack.device)
    if valid.numel() == 0:  # nothing to march: no launch
        buf[:, : 4 + 2 * n2] = 0.0
        buf[:, 4 + 2 * n2 :] = math.inf
        return buf
    layers, normal, inlier, inlier_stride, new_layers, frac = snapshot or (None, None, None, 0, None, None)
    KERNEL.launch(
        pack.device, pack.data_ptr(), world.data_ptr(), valid.data_ptr(), t.data_ptr(), gate_ptr, buf.data_ptr(),
        b, n_rays, cfg.cell_n, block.r0, block.c0, block.h, block.w,
        cfg.resolution, cfg.ray_step, cfg.n_ray_steps,
        cfg.max_ray_length, cfg.cleanup_step, cfg.cleanup_cos_thresh,
        seg, gblock, gate_r0, gate_c0, rows, cols, eps, LANES_GATED if gate is not None else LANES_FLAT,
        *(None if x is None else x.data_ptr() for x in (layers, normal, inlier)), inlier_stride,
        *(None if x is None else x.data_ptr() for x in (new_layers, frac)),
        cfg.wall_num_thresh, cfg.outlier_variance,
    )
    return buf


def exact_cleanup(
    layers: torch.Tensor,
    normal: torch.Tensor,
    inlier_cnt: torch.Tensor,
    world: torch.Tensor,
    valid: torch.Tensor,
    t: torch.Tensor,
    cfg: MapConfig,
    gate: Optional[Gate] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The exact cleanup of whole maps on the card in one K2 launch: the
    pack (``raycast.exact_precompute``) and, with ``gate`` (a :class:`Gate`
    whose ``table`` is None: the kernel builds it, ``raycast.exact_gate``),
    the march, and the new layers. ``layers`` (B, 7, n, n), ``normal`` (B,
    3, n, n), ``inlier_cnt`` (B, n, n), ``world`` (B, N, 3), ``valid`` (B,
    N), ``t`` (B, 3), all float32 but ``valid``, on one card. Returns the new
    layers and, with a gate, the segment survivor fraction per map (B,),
    0.0 where no segment was live; without a gate None. Refuses CPU
    tensors: their cleanup is ``raycast.visibility_cleanup_exact``'s
    composition of the plain parts."""
    n = cfg.cell_n
    b = layers.shape[0]
    if layers.shape != (b, 7, n, n) or normal.shape != (b, 3, n, n) or inlier_cnt.shape != (b, n, n):
        raise ValueError(f"the cleanup takes (B, 7, {n}, {n}) layers, (B, 3, {n}, {n}) normals and (B, {n}, {n}) "
                         f"inlier counts; got {tuple(layers.shape)}, {tuple(normal.shape)}, {tuple(inlier_cnt.shape)}")
    if gate is not None and gate.table is not None:
        raise ValueError("exact_cleanup builds the gate table itself: give a Gate whose table is None")
    if any(x.dtype != torch.float32 for x in (layers, normal, inlier_cnt)):
        raise TypeError("exact_cleanup's kernel takes float32 layers, normals and inlier counts")
    if not on_card(layers, "exact_cleanup"):
        raise ValueError("exact_cleanup runs on the card; compose the plain parts on the CPU")
    block = Block.whole(n, n)
    pack = torch.empty((b, n * n, PACK_WIDTH), dtype=torch.float32, device=layers.device)
    if gate is not None:
        nb = -(-n // gate.block)
        gate = gate._replace(table=torch.empty((b, nb, nb), dtype=torch.float32, device=layers.device),
                             origin=(0, 0))
    _check(pack, world, valid, t, cfg, gate, block)
    if any(x.dtype != torch.float32 for x in (world, t)):
        raise TypeError("exact_cleanup's kernel takes float32 world and t")
    if valid.numel() == 0:  # nothing to march: no launch, nothing changes
        return layers.clone(), (None if gate is None else torch.zeros((b,), dtype=torch.float32, device=layers.device))
    layers, normal, world, valid, t = (x.contiguous() for x in (layers, normal, world, valid, t))
    if inlier_cnt.stride()[1:] != (n, 1):
        inlier_cnt = inlier_cnt.contiguous()
    new_layers = torch.empty_like(layers)
    frac = torch.empty((b,), dtype=torch.float32, device=layers.device) if gate is not None else None
    _launch(pack, world, valid, t, cfg, gate, block,
            (layers, normal, inlier_cnt, inlier_cnt.stride(0), new_layers, frac))
    return new_layers, frac
