"""Functional core: one geometric map update and the map maintenance steps.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/core.py``: the
geometric update, the same update with semantic channels, the image path
and the maintenance steps. Every function takes a ``MapState`` and returns
a new one; the input state's tensors are not written. The state's device
decides where the work runs: on a CUDA state the scatters launch kernel K1,
the per-point chain around them D4 and D5 and the exact cleanup kernel K2,
on a CPU state they take their plain versions.

A state may also be a batch of B independent maps (a leading axis on every
field, ``state.init_batch``), with the same leading axis on its per-map
inputs: ``update_batch_aux`` updates a batch, and the per-map updates are it
at B = 1 (one code path); the image path, the motion and maintenance steps
take either. Every stage of a batched update runs once for all maps: K1
once per scatter stage for the whole batch, the exact march as one K2
launch at any B, and nothing is read back to the host (``move_to`` computes
each map's whole-cell shift on the device).

The update also runs on one process's block of a spatially sharded map
(``parallel/spatial.py``): given a ``shard``, the state holds the block
with its ghost zone, every stage works on those cells, and the few sums
over the whole map go through the shard's collectives.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple, Union

import torch

from . import tracing
from .config import MapConfig
from .nn.traversability import TravFilter
from .ops import image as img_ops
from .ops import point_stages
from .ops import pointcloud as pc
from .ops import raycast as rc
from .ops import scatter, stencil
from .ops.geometry import PointAssociation, associate_points, true_div
from .semantic.update import reset_sem_new, resolve_channels, update_semantic_pointcloud
from .state import MapState, stack_tensors, take_map

__all__ = [
    "update_pointcloud",
    "update_pointcloud_aux",
    "update_pointcloud_semantic",
    "update_batch_aux",
    "image_correspondence",
    "input_image",
    "move_to",
    "move",
    "shift_map_xy",
    "shift_map_z",
    "update_variance",
    "update_time",
    "update_upper_bound_with_valid_elevation",
    "clear",
    "update_normal",
]

Scalar = Union[float, torch.Tensor]


# ---------------------------------------------------------------------------
# pointcloud update (hot path)
# ---------------------------------------------------------------------------

@torch.no_grad()
def update_pointcloud(
    state: MapState,
    points: torch.Tensor,       # (N, 3) sensor-frame xyz, padded
    pad_mask: torch.Tensor,     # (N,) bool, True = real point
    R: torch.Tensor,            # (3, 3) sensor rotation
    t: torch.Tensor,            # (3,)  sensor translation (world frame)
    position_noise: Scalar,
    orientation_noise: Scalar,
    weights: TravFilter,
    cfg: MapConfig,
) -> MapState:
    """Full geometric update for one pointcloud (no semantic channels).

    Mirrors update_map_with_kernel (elevation_mapping.py:316-391): error
    counting -> drift compensation -> Kalman fusion -> visibility cleanup ->
    averaging -> overlap clearance -> dilation -> traversability CNN ->
    normals.
    """
    return _update_impl(state, points, pad_mask, R, t, position_noise, orientation_noise, weights, cfg)[0]


@torch.no_grad()
def update_pointcloud_aux(
    state: MapState,
    points: torch.Tensor,
    pad_mask: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    position_noise: Scalar,
    orientation_noise: Scalar,
    weights: TravFilter,
    cfg: MapConfig,
) -> Tuple[MapState, Dict[str, torch.Tensor]]:
    """``update_pointcloud`` plus the cleanup's aux dict: ``gate_survivor_frac``
    (0-d tensor), the gated march's segment survivor fraction and 1.0 for
    every other cleanup, which feeds ``ops.raycast.AdaptiveExactRouter``."""
    return _update_impl(state, points, pad_mask, R, t, position_noise, orientation_noise, weights, cfg)


@torch.no_grad()
def update_pointcloud_semantic(
    state: MapState,
    points_all: torch.Tensor,   # (N, 3 + C) xyz + semantic channel columns
    pad_mask: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    position_noise: Scalar,
    orientation_noise: Scalar,
    weights: TravFilter,
    cfg: MapConfig,
    channels: Sequence[str],    # semantic channel names (columns 3..)
) -> MapState:
    """Geometric update + MEM semantic fusion sharing one association pass
    (reference: update_map_with_kernel + SemanticMap.update_layers_pointcloud)."""
    return _update_impl(
        state, points_all, pad_mask, R, t, position_noise, orientation_noise, weights, cfg, tuple(channels)
    )[0]


def _update_impl(
    state: MapState,
    points: torch.Tensor,
    pad_mask: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    position_noise: Scalar,
    orientation_noise: Scalar,
    weights: TravFilter,
    cfg: MapConfig,
    channels: Tuple[str, ...] = (),
) -> Tuple[MapState, Dict[str, torch.Tensor]]:
    """One update of one map: the batched update at B = 1."""
    with tracing.span("core.update"):
        out, aux = update_batch_aux(
            MapState(*(x[None] for x in state)), points[None], pad_mask[None], R[None], t[None],
            position_noise, orientation_noise, weights, cfg, channels,
        )
        return take_map(out, 0), {k: v[0] for k, v in aux.items()}


@torch.no_grad()
def update_batch_aux(
    state: MapState,            # batched: (B, ...) on every field
    points: torch.Tensor,       # (B, N, 3 + C)
    pad_mask: torch.Tensor,     # (B, N)
    R: torch.Tensor,            # (B, 3, 3)
    t: torch.Tensor,            # (B, 3)
    position_noise: Scalar,     # (B,) or one value for every map
    orientation_noise: Scalar,
    weights: TravFilter,        # shared by every map
    cfg: MapConfig,
    channels: Tuple[str, ...] = (),
    shard=None,
) -> Tuple[MapState, Dict[str, torch.Tensor]]:
    """The update of B maps in one pass: every stage over the whole batch,
    K1 once per scatter stage, the exact march as one K2 launch. Returns the new batched state and the
    cleanup's aux (``gate_survivor_frac``, one per map). The semantic
    fusions (``channels``) run map by map.

    With ``shard`` (``parallel.spatial.SpatialShard``) the state's map
    tensors are the cells of ``shard.block``: this process's block of a
    sharded map with its ghost zone. Every stage runs on those cells as on
    the whole map; the drift compensation's error sums (over the points of
    the block this process owns), the gated march's segment counts and
    class_max's class ids are joined over the shard's processes. The
    result's ghost cells hold what the stencils could reach from the block:
    the caller keeps the owned block."""
    dev, dt = state.layers.device, state.layers.dtype
    position_noise = tracing.upload(position_noise, dev, dt)
    orientation_noise = tracing.upload(orientation_noise, dev, dt)
    block = None if shard is None else shard.block
    # the stages: host spans, timed on the stream too while a profiler runs
    on_card = dev.type == "cuda"

    t_c = t - state.center  # shift_translation_to_map_center
    args = (state, points, pad_mask, R, t_c, position_noise, orientation_noise, cfg, on_card)
    fused = _fuse_points(*args) if shard is None else _fuse_points_sharded(*args, shard)
    assoc, inlier_cnt, layers, newmap, mean_error, additive = fused
    layers, ray_aux = rc.visibility_cleanup(
        layers, state.normal, assoc, inlier_cnt, t_c, cfg, with_aux=True,
        block=block, reduce=None if shard is None else shard.sum,
    )
    with tracing.span("core.average", stream=on_card):
        layers = pc.average_map(layers, newmap, cfg)

    semantic, sem_new, id_max = state.semantic, state.sem_new, state.id_max
    if channels:
        with tracing.span("core.semantic", stream=on_card):
            per_map = [
                update_semantic_pointcloud(
                    semantic[b],
                    sem_new[b],
                    id_max[b],
                    assoc.map(b),
                    points[b, :, 3 : 3 + len(channels)],
                    channels,
                    newmap[b, 2],
                    cfg,
                    None if shard is None else shard.gather,
                )
                for b in range(layers.shape[0])
            ]
            semantic, sem_new, id_max = (stack_tensors(xs) for xs in zip(*per_map))

    if cfg.enable_overlap_clearance:
        with tracing.span("core.overlap_clearance", stream=on_card):
            layers = pc.clear_overlap(layers, t_c, cfg, block)
    with tracing.span("core.dilation", stream=on_card):
        height, height_mask = layers[:, 5], layers[:, 2] + layers[:, 6]
        edges = None
        if shard is not None:
            edges = shard.edges(torch.stack([height, height_mask], dim=-3), cfg.dilation_size)
        trav_input, _ = stencil.dilation_fill(height, height_mask, cfg.dilation_size, block, edges)
    with tracing.span("core.traversability", stream=on_card):
        layers = _apply_traversability(layers, trav_input, weights)
    with tracing.span("core.normals", stream=on_card):
        normal = stencil.surface_normals(trav_input, layers[:, 2], cfg.resolution, block)
    out = state._replace(
        layers=layers,
        normal=normal,
        semantic=semantic,
        sem_new=sem_new,
        id_max=id_max,
        mean_error=mean_error,
        additive_mean_error=additive,
    )
    return out, ray_aux


class _Fused(NamedTuple):
    """What the per-point stages of an update hand on to the cleanup."""

    assoc: PointAssociation
    inlier_cnt: torch.Tensor  # (B, H, W) drift-compensation inliers per cell
    layers: torch.Tensor      # after the drift compensation and the fusion
    newmap: torch.Tensor      # (B, 3, H, W) the fusion's sums for average_map
    mean_error: torch.Tensor
    additive: torch.Tensor


def _drift(state, layers, counts, position_noise, orientation_noise, cfg, on_card):
    with tracing.span("core.drift", stream=on_card):
        return pc.apply_drift_compensation(
            layers, counts, position_noise, orientation_noise, state.mean_error, state.additive_mean_error, cfg
        )


def _fuse_points(state, points, pad_mask, R, t_c, position_noise, orientation_noise, cfg, on_card) -> _Fused:
    """Association, error counting, drift compensation and Kalman fusion of
    whole maps: on the card D4, K1, D5 and K1 (``ops/point_stages.py``),
    the plain versions of D4 and D5 on the CPU."""
    h, w = state.layers.shape[-2:]
    with tracing.span("core.associate", stream=on_card):
        stage = point_stages.associate(points, pad_mask, R, t_c, state.layers, cfg)
        assoc = stage.assoc
    with tracing.span("core.error_counting", stream=on_card):
        sums = scatter.scatter_add_streams_2d(h, w, assoc.flat_idx, stage.counted, assoc.mask)
        counts = pc.ErrorCounts(sums[:, 0], sums[:, 1], stage.error_sum, stage.error_cnt)
    layers, mean_error, additive, h_delta = _drift(
        state, state.layers, counts, position_noise, orientation_noise, cfg, on_card
    )
    # fusion decisions read the drift-compensated snapshot (R1)
    with tracing.span("core.fusion", stream=on_card):
        streams, active = point_stages.fuse(stage, h_delta, counts.point_cnt, cfg)
        layers, newmap = pc.fusion_apply(layers, scatter.scatter_add_multi(h * w, assoc.flat_idx, streams, active), cfg)
    return _Fused(assoc, counts.inlier_cnt, layers, newmap, mean_error, additive)


def _fuse_points_sharded(state, points, pad_mask, R, t_c, position_noise, orientation_noise, cfg, on_card,
                         shard) -> _Fused:
    """:func:`_fuse_points` on one process's block of a sharded map, in
    eager stages: the association localised to the block, the error sums
    over the points this process owns and joined over the shard."""
    dt = state.layers.dtype
    with tracing.span("core.associate", stream=on_card):
        assoc = associate_points(points[..., :3], pad_mask, R, t_c, cfg, shard.block)
        layers = state.layers
        # one shared row-gather of the point cells feeds both stages
        cell_rows = pc.gather_cell_rows(layers, assoc.flat_idx)
    with tracing.span("core.error_counting", stream=on_card):
        counts = pc.error_counting(layers, assoc, cfg, cell_rows, owned=shard.owns(assoc.flat_idx))
        sums = shard.sum(torch.stack([counts.error_sum.double(), counts.error_cnt.double()]))
        counts = counts._replace(error_sum=sums[0].to(dt), error_cnt=sums[1].to(counts.error_cnt.dtype))
    layers, mean_error, additive, h_delta = _drift(
        state, layers, counts, position_noise, orientation_noise, cfg, on_card
    )
    # fusion decisions read the drift-compensated snapshot (R1)
    with tracing.span("core.fusion", stream=on_card):
        layers, newmap = pc.point_fusion(layers, assoc, counts.point_cnt, cfg, cell_rows, h_delta)
    return _Fused(assoc, counts.inlier_cnt, layers, newmap, mean_error, additive)


@torch.no_grad()
def image_correspondence(
    state: MapState,
    image_height: int,
    image_width: int,
    R: torch.Tensor,
    t: torch.Tensor,
    K: torch.Tensor,
    D: torch.Tensor,
    cfg: MapConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell pixel coordinates and visibility of a camera's image,
    (uv (..., 2, H, W), valid (..., H, W) bool): P = K[R|t], the camera
    cell, then ``ops.image.image_to_map_correspondence``. A batched state
    takes (B, 3, 3) rotations, (B, 3) translations, (B, 3, 3) intrinsics and
    (B, 5) distortions."""
    # P = K @ [R|t] and -R^T t as explicit sums of products: float32
    # whatever the matmul precision flags say
    Rt = torch.cat([R, t[..., :, None]], dim=-1)
    P = (K[..., :, :, None] * Rt[..., None, :, :]).sum(dim=-2)
    t_cam_map = -(R * t[..., :, None]).sum(dim=-2) - state.center
    # uint32 truncation of cell coordinates (elevation_mapping.py:532-533)
    cam_xy_cell = torch.floor(cfg.cell_n / 2 + true_div(t_cam_map[..., :2], cfg.resolution)).to(torch.int64)
    return img_ops.image_to_map_correspondence(
        state.layers, state.center, cam_xy_cell, t_cam_map[..., 2], P, K, D,
        float(image_height), float(image_width), cfg,
    )


@torch.no_grad()
def input_image(
    state: MapState,
    image: torch.Tensor,        # (C_img, H_i, W_i) channel-stacked image
    R: torch.Tensor,            # (3, 3) camera optical rotation (world->cam)
    t: torch.Tensor,            # (3,)  camera optical translation
    K: torch.Tensor,            # (3, 3) intrinsics
    D: torch.Tensor,            # (5,)  radtan distortion (pre-normalized)
    cfg: MapConfig,
    channels: Sequence[str],    # semantic channel names
) -> MapState:
    """Fuse an image into semantic layers (elevation_mapping.py:468-562):
    the per-cell uv correspondence with its occlusion test
    (``cfg.image_occlusion_mode``), then the per-channel image fusions. A
    batched state takes one image per map, (B, C_img, H_i, W_i), and (B, ...)
    camera parameters, all maps in one pass.
    """
    image_width = float(image.shape[-1])
    uv, valid = image_correspondence(state, image.shape[-2], image.shape[-1], R, t, K, D, cfg)

    sem_new = reset_sem_new(state.sem_new, cfg)
    # Channel -> image-plane mapping: a color channel consumes THREE planes
    # (the C++ node validates "rgb counts for 3 layers",
    # elevation_mapping_ros.cpp:428-441). The reference Python then indexes
    # fusions by channel POSITION (image[j], image_exponential.py:69), which
    # silently reads the wrong plane whenever a color channel precedes a
    # mono one — here a plane cursor advances by each channel's true width.
    plane_of = {}
    cursor = 0
    for col, ch in enumerate(channels):
        plane_of[col] = cursor
        fus = cfg.fusion_for_channel(ch, "image")
        cursor += 3 if (fus == "color" or ch == "rgb") else 1

    semantic = state.semantic.clone()
    for col, lay, fusion in resolve_channels(channels, cfg, "image"):
        off = plane_of[col]
        layer = semantic[..., lay, :, :]
        if fusion == "color":
            layer[...] = img_ops.image_fuse_color(layer, image[..., off : off + 3, :, :], uv, valid, image_width)
        elif fusion == "exponential":
            layer[...] = img_ops.image_fuse_exponential(
                layer, image[..., off, :, :], uv, valid, image_width, cfg.image_exponential_alpha
            )
        elif fusion == "average":
            layer[...] = img_ops.image_fuse_replace(layer, image[..., off, :, :], uv, valid, image_width)
    return state._replace(semantic=semantic, sem_new=sem_new)


def _apply_traversability(layers: torch.Tensor, trav_input: torch.Tensor, weights: TravFilter) -> torch.Tensor:
    trav = weights(trav_input)
    out = layers.clone()
    out[..., 3, 3:-3, 3:-3] = trav.to(layers.dtype)
    return out


@torch.no_grad()
def update_normal(state: MapState, input_map: torch.Tensor, cfg: MapConfig) -> MapState:
    """Recompute normals from an arbitrary height layer (elevation_mapping.py:564-577)."""
    return state._replace(normal=stencil.surface_normals(input_map, state.layers[..., 2, :, :], cfg.resolution))


# ---------------------------------------------------------------------------
# recentering (elevation_mapping.py:139-226)
# ---------------------------------------------------------------------------

class _Shift(NamedTuple):
    """A whole-cell roll of the last two axes, per map, as gather indices:
    ``rows``/``cols`` (..., n) are the source row and column of each output
    row and column, ``revealed`` (..., n, n) the cells the roll uncovers."""

    rows: torch.Tensor
    cols: torch.Tensor
    revealed: torch.Tensor


def _shift(s0, s1, n: int, device) -> _Shift:
    """The roll by (s0, s1) cells (ints, or tensors of one value per map)
    as ``cp.roll`` + pad_value does it: output cell (i, j) takes input cell
    ((i - s0) mod n, (j - s1) mod n), and the rows and columns the shift
    brings in are revealed. Computed on the device, so a batch of maps can
    each move by its own shift without a read-back (the traced ``_roll_pad``
    of the JAX package's core.py:288-320)."""
    s0 = torch.as_tensor(s0, device=device).to(torch.int64)
    s1 = torch.as_tensor(s1, device=device).to(torch.int64)
    r = torch.arange(n, device=device)
    rows = torch.remainder(r - s0[..., None], n)
    cols = torch.remainder(r - s1[..., None], n)
    m0 = torch.where(s0[..., None] > 0, r < s0[..., None], r >= n + s0[..., None])
    m1 = torch.where(s1[..., None] > 0, r < s1[..., None], r >= n + s1[..., None])
    revealed = m0[..., :, None] | m1[..., None, :]
    return _Shift(rows, cols, revealed)


def _roll(x: torch.Tensor, sh: _Shift) -> torch.Tensor:
    """An (batch..., L, n, n) stack rolled by ``sh`` (batch...): two
    gathers, bit for bit what ``torch.roll`` gives."""
    lead = sh.rows.shape[:-1]
    n = x.shape[-1]
    rows = sh.rows.reshape(*lead, 1, n, 1).expand(x.shape)
    cols = sh.cols.reshape(*lead, 1, 1, n).expand(x.shape)
    return torch.gather(torch.gather(x, -2, rows), -1, cols)


def shift_cells(state: MapState, roll, revealed: torch.Tensor, cfg: MapConfig) -> MapState:
    """Every map-shaped field moved by ``roll`` (a function of an (..., L,
    H, W) stack) with the cells ``revealed`` (..., H, W) reset: variance to
    initial_variance, everything else 0 (cp.roll + pad_value)."""
    rolled = roll(state.layers)
    layers = torch.where(revealed[..., None, :, :], 0.0, rolled)
    layers[..., 1, :, :] = torch.where(revealed, cfg.initial_variance, rolled[..., 1, :, :])

    def pad(x, value):
        return x if x.numel() == 0 else torch.where(revealed[..., None, :, :], value, roll(x))

    return state._replace(
        layers=layers,
        semantic=pad(state.semantic, 0.0),
        sem_new=pad(state.sem_new, 0.0),
        id_max=pad(state.id_max, 0),
    )


def shift_map_xy(state: MapState, s0, s1, cfg: MapConfig) -> MapState:
    """Roll all layer stacks by integer cells (s0 along rows, s1 along
    columns); newly revealed cells reset (variance to initial_variance,
    everything else 0). The shifts are ints or tensors, one value per map of
    a batched state."""
    sh = _shift(s0, s1, state.layers.shape[-1], state.layers.device)
    return shift_cells(state, lambda x: _roll(x, sh), sh.revealed, cfg)


def shift_map_z(state: MapState, delta_z: torch.Tensor) -> MapState:
    """Shift heights and upper bounds by ``delta_z`` (one value per map)."""
    layers = state.layers.clone()
    dz = delta_z[..., None, None]
    layers[..., 0, :, :] += dz
    layers[..., 5, :, :] += dz
    return state._replace(layers=layers)


def _pixel_shift(delta_xy: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """round(delta / resolution): the whole-cell shift, (..., 2)."""
    return torch.round(true_div(delta_xy, cfg.resolution))


@torch.no_grad()
def move_to(state: MapState, position: torch.Tensor, R: torch.Tensor, cfg: MapConfig, shift_xy=None) -> MapState:
    """Shift the map to an absolute position (elevation_mapping.py:154-170).
    A batched state takes (B, 3) positions and (B, 3, 3) rotations; each map
    moves by its own whole-cell shift, computed on the device. ``shift_xy``
    replaces :func:`shift_map_xy` (a sharded map's moves cells between
    processes)."""
    with tracing.span("core.move_to", stream=state.layers.is_cuda):
        delta = position - state.center
        delta_pixel = _pixel_shift(delta[..., :2], cfg)
        center = state.center.clone()
        center[..., :2] += delta_pixel * cfg.resolution
        center[..., 2] += delta[..., 2]
        state = state._replace(center=center, rotation=R.to(state.rotation.dtype))
        state = (shift_map_xy if shift_xy is None else shift_xy)(state, -delta_pixel[..., 0], -delta_pixel[..., 1], cfg)
        return shift_map_z(state, -delta[..., 2])


@torch.no_grad()
def move(state: MapState, delta_position: torch.Tensor, cfg: MapConfig) -> MapState:
    """Relative shift (elevation_mapping.py:139-152); like ``move_to``, on
    one map or a batch."""
    delta_pixel = _pixel_shift(delta_position[..., :2], cfg)
    center = state.center.clone()
    center[..., :2] += delta_pixel * cfg.resolution
    center[..., 2] += delta_position[..., 2]
    state = state._replace(center=center)
    state = shift_map_xy(state, delta_pixel[..., 0], delta_pixel[..., 1], cfg)
    return shift_map_z(state, -delta_position[..., 2])


# ---------------------------------------------------------------------------
# timers & maintenance (elevation_mapping.py:119-127, 420-432)
# ---------------------------------------------------------------------------

@torch.no_grad()
def update_variance(state: MapState, cfg: MapConfig) -> MapState:
    layers = state.layers.clone()
    layers[..., 1, :, :] += cfg.time_variance * state.layers[..., 2, :, :]
    return state._replace(layers=layers)


@torch.no_grad()
def update_time(state: MapState, cfg: MapConfig) -> MapState:
    layers = state.layers.clone()
    layers[..., 4, :, :] += cfg.time_interval
    return state._replace(layers=layers)


@torch.no_grad()
def update_upper_bound_with_valid_elevation(state: MapState) -> MapState:
    mask = state.layers[..., 2, :, :] > 0.5
    layers = state.layers.clone()
    layers[..., 5, :, :] = torch.where(mask, layers[..., 0, :, :], layers[..., 5, :, :])
    layers[..., 6, :, :] = torch.where(mask, 0.0, layers[..., 6, :, :])
    return state._replace(layers=layers)


@torch.no_grad()
def clear(state: MapState, cfg: MapConfig) -> MapState:
    layers = torch.zeros_like(state.layers)
    layers[..., 1, :, :] = cfg.initial_variance
    return state._replace(
        layers=layers,
        semantic=torch.zeros_like(state.semantic),
        sem_new=torch.zeros_like(state.sem_new),
        id_max=torch.zeros_like(state.id_max),
        mean_error=torch.zeros_like(state.mean_error),
        additive_mean_error=torch.zeros_like(state.additive_mean_error),
    )
