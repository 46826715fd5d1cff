"""Multi-modal (MEM) fusion algorithms for semantic layers.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/semantic/fusions.py``:
functional re-derivations of the reference fusion plugins
(fusion/pointcloud_*.py, fusion/image_*.py) on top of the shared point->cell
association. Every scatter-add goes through ``ops/scatter`` and so, on a CUDA
tensor, through kernel K1.

Known reference quirks reproduced or documented:
  * the per-cell denominators of `average`/`class_average` use the *elevation*
    inlier count (new_elmap layer 2), not the semantic point count
    (pointcloud_average.py:72-76);
  * the sum kernels gate only on (valid, inside) — Mahalanobis outliers do
    contribute to semantic sums (custom_semantic_kernels.py:40-46);
  * `bayesian_inference` keeps its posterior variance in a per-update buffer
    that the reference zeroes every update, freezing the posterior
    (semantic_map.py:243 + pointcloud_bayesian_inference.py TODO at :100).
    The same storage layout (sem_new) and its reset policy are reproduced so
    behavior matches bit-for-bit; fixing it is a config knob away.
  * reference kernels launched with ``size=N`` instead of ``size=N*L``
    (sum_compact/alpha/add_color) silently drop (point, channel) pairs when a
    fusion owns more than one layer. The mathematically intended all-pairs
    behavior is implemented; identical for the reference's shipped configs
    (L=1).

Packed layers. A colour layer holds ``0x00RRGGBB`` in the bits of a float32
(a denormal, or with red from 128 up a normal number below 2.4e-38) and a
`class_max` feature holds ``(class id << 16) | float16 bits`` (ids from
0x7F80 up are NaN or infinity patterns). Such values are only ever moved (``where``, ``roll``, indexing,
copies) and never enter arithmetic; K1 sums the unpacked integers. The
unsigned 32-bit fields are handled as int64 (PyTorch has next to no uint32
arithmetic, and an int32 ``>>`` would sign-extend).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import MapConfig
from ..ops import scatter
from ..ops.geometry import PointAssociation

__all__ = [
    "SemanticUpdate",
    "fuse_average",
    "fuse_class_average",
    "fuse_bayesian_inference",
    "fuse_class_bayesian",
    "fuse_class_max",
    "fuse_color",
    "decode_max",
    "encode_max",
    "rgb_float_to_uint",
    "uint_to_rgb_float",
    "POINTCLOUD_FUSIONS",
    "PERSISTENT_NEW",
]

UNIQUE_FILL = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# float32 bit-packing helpers (semantic_map.py:311-327, test helpers)
# ---------------------------------------------------------------------------

def _float_bits(v: torch.Tensor) -> torch.Tensor:
    """The 32 bits of each float32 as an int64 in [0, 2^32)."""
    return v.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _bits_float(bits: torch.Tensor) -> torch.Tensor:
    """int64 values (their low 32 bits) to the float32 with those bits."""
    bits = bits & 0xFFFFFFFF
    signed = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return signed.to(torch.int32).view(torch.float32)


def decode_max(mer: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (prob float32, class id int64): low 16 bits are a float16
    probability, high 16 bits the class id. A NaN half gives a NaN whose
    payload depends on the device's half -> float conversion."""
    bits = _float_bits(mer)
    lo = bits & 0xFFFF
    half = torch.where(lo >= 1 << 15, lo - (1 << 16), lo).to(torch.int16)
    prob = half.view(torch.float16).to(torch.float32)
    return prob, bits >> 16


def encode_max(prob: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """(prob, class id) -> float32 with the float16 of ``prob`` (rounded to
    nearest even) in its low and the id in its high 16 bits."""
    lo = prob.to(torch.float16).contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
    return _bits_float((cls.to(torch.int64) << 16) | lo)


def rgb_float_to_uint(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    bits = _float_bits(v)
    return (bits >> 16) & 0xFF, (bits >> 8) & 0xFF, bits & 0xFF


def uint_to_rgb_float(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _bits_float((r.to(torch.int64) << 16) | (g.to(torch.int64) << 8) | b.to(torch.int64))


# ---------------------------------------------------------------------------

class SemanticUpdate(NamedTuple):
    semantic: torch.Tensor   # (S, H, W)
    sem_new: torch.Tensor    # (S, H, W)
    id_max: torch.Tensor     # (S, H, W) int64 (uint32 values)


def _sum_features(
    up: SemanticUpdate,
    assoc: PointAssociation,
    feats: torch.Tensor,     # (N, L) feature columns for this fusion
) -> torch.Tensor:
    """Σ feature per cell for each layer (sum_kernel), one K1 launch of L
    streams over the cells of ``up``'s layers. Returns (L, H, W)."""
    h, w = up.semantic.shape[-2:]
    streams = [feats[:, k] for k in range(feats.shape[1])]
    mask = assoc.valid & assoc.inside
    return scatter.scatter_add_streams_2d(h, w, assoc.flat_idx, streams, mask)


def fuse_average(
    up: SemanticUpdate,
    assoc: PointAssociation,
    feats: torch.Tensor,
    layer_ids: Sequence[int],
    elev_cnt: torch.Tensor,  # (H, W) elevation newmap count
    cfg: MapConfig,
) -> SemanticUpdate:
    """pointcloud_average (pointcloud_average.py:83-113)."""
    sums = _sum_features(up, assoc, feats)
    cnt = elev_cnt
    has = cnt > 0
    safe = torch.clamp(cnt, min=1.0)
    sem = up.semantic.clone()
    new = up.sem_new.clone()
    for k, lay in enumerate(layer_ids):
        new[lay] += sums[k]
        sem[lay] = torch.where(has, new[lay] / safe, sem[lay])
    return up._replace(semantic=sem, sem_new=new)


def fuse_class_average(
    up: SemanticUpdate,
    assoc: PointAssociation,
    feats: torch.Tensor,
    layer_ids: Sequence[int],
    elev_cnt: torch.Tensor,
    cfg: MapConfig,
) -> SemanticUpdate:
    """pointcloud_class_average: EMA with alpha=average_weight
    (pointcloud_class_average.py:94-126)."""
    a = cfg.average_weight
    sums = _sum_features(up, assoc, feats)
    cnt = elev_cnt
    has = cnt > 0
    safe = torch.clamp(cnt, min=1.0)
    sem = up.semantic.clone()
    new = up.sem_new.clone()
    for k, lay in enumerate(layer_ids):
        new[lay] += sums[k]
        mean = new[lay] / safe
        prev = sem[lay]
        val = torch.where(prev == 0, mean, a * prev + (1 - a) * mean)
        sem[lay] = torch.where(has, val, prev)
    return up._replace(semantic=sem, sem_new=new)


def fuse_bayesian_inference(
    up: SemanticUpdate,
    assoc: PointAssociation,
    feats: torch.Tensor,
    layer_ids: Sequence[int],
    elev_cnt: torch.Tensor,
    cfg: MapConfig,
) -> SemanticUpdate:
    """pointcloud_bayesian_inference (pointcloud_bayesian_inference.py:83-122).

    Gaussian posterior per cell with measurement sigma=1; the posterior
    variance lives in sem_new[lay] (reference: new_map), subject to the same
    per-update reset policy as the reference.
    """
    sums = _sum_features(up, assoc, feats)
    cnt = elev_cnt
    has = cnt > 0
    safe = torch.clamp(cnt, min=1.0)
    sem = up.semantic.clone()
    new = up.sem_new.clone()
    for k, lay in enumerate(layer_ids):
        feat_ml = sums[k] / safe
        feat_old = sem[lay]
        sigma_old = new[lay]
        sigma = 1.0
        denom = cnt * sigma_old + sigma
        feat_new = sigma * feat_old / denom + cnt * sigma_old * feat_ml / denom
        sigma_new = sigma * sigma_old / denom
        sem[lay] = torch.where(has, feat_new, feat_old)
        new[lay] = torch.where(has, sigma_new, sigma_old)
    return up._replace(semantic=sem, sem_new=new)


def _normalised(alpha: torch.Tensor) -> torch.Tensor:
    """alpha / Σ_layers alpha per cell, a zero sum taken as 1."""
    sum_alpha = torch.sum(alpha, dim=0)
    sum_alpha = torch.where(sum_alpha == 0, 1.0, sum_alpha)
    return alpha / sum_alpha[None]


def fuse_class_bayesian(
    up: SemanticUpdate,
    assoc: PointAssociation,
    feats: torch.Tensor,
    layer_ids: Sequence[int],
    elev_cnt: torch.Tensor,
    cfg: MapConfig,
) -> SemanticUpdate:
    """pointcloud_class_bayesian: Dirichlet alpha accumulation + normalization
    (pointcloud_class_bayesian.py:53-75). sem_new (alpha) persists across
    updates (delete_new_layers=0, semantic_map.py:54-56)."""
    # alpha_kernel: theta < 0 leaves (arg_max=0, theta_max=0) and adds 0 —
    # negative features contribute nothing (custom_semantic_kernels.py:150-157)
    f = torch.clamp(feats, min=0.0)
    sums = _sum_features(up, assoc, f)
    lays = list(layer_ids)
    new = up.sem_new.clone()
    for k, lay in enumerate(lays):
        new[lay] += sums[k]
    sem = up.semantic.clone()
    sem[lays] = _normalised(new[lays])
    return up._replace(semantic=sem, sem_new=new)


def fuse_class_max(
    up: SemanticUpdate,
    assoc: PointAssociation,
    feats: torch.Tensor,     # (N, L) bit-packed prob/class values
    layer_ids: Sequence[int],
    elev_cnt: torch.Tensor,
    cfg: MapConfig,
    max_classes: int = 32,
    id_union: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> SemanticUpdate:
    """pointcloud_class_max (pointcloud_class_max.py:49-123).

    The reference's dynamic `cp.unique` over present class ids becomes a
    static-size bucketing (the ``max_classes`` smallest distinct ids), then
    a per-(point, layer) scatter into (bucket, cell) probability sums (one
    K1 launch of N*L points over max_classes*n*n bins) and a per-layer
    arg-max sweep. Class ids beyond `max_classes` distinct values are
    dropped (masked, never mis-credited to another bucket).

    Note the overwrite semantics are reference-faithful: the reference also
    rebuilds new_map purely from the current cloud's prob_sum — its
    "add the previous alpha" merge is commented out as TODO
    (pointcloud_class_max.py:108-113); persistence of sem_new/id_max only
    affects id bucketing (unique over existing ids) and map shifting.

    On a block of a sharded map the ids in use are the whole map's:
    ``id_union`` gathers every process's ``max_classes`` smallest ids
    (whose union holds the whole map's smallest), and the bucketing takes
    the smallest of those.
    """
    h, w = up.semantic.shape[-2:]
    lays = list(layer_ids)
    n_lay = feats.shape[1]
    prob, cls = decode_max(feats)            # (N, L) each
    cls = cls.reshape(-1)
    mask = assoc.valid & assoc.inside

    existing = up.id_max[lays].reshape(-1)
    uniq = scatter.smallest_unique(torch.cat([cls, existing]), max_classes, UNIQUE_FILL)
    if id_union is not None:
        uniq = scatter.smallest_unique(id_union(uniq), max_classes, UNIQUE_FILL)

    # bucket each (point, layer) class id; ids that fell off the static
    # unique (> max_classes distinct) would searchsorted onto a different
    # class's bucket — mask them out instead
    bucket = torch.clamp(torch.searchsorted(uniq, cls), max=max_classes - 1)  # (N*L,)
    found = uniq[bucket] == cls
    cell = torch.repeat_interleave(assoc.flat_idx, n_lay)
    pmask = torch.repeat_interleave(mask, n_lay) & found
    flat = bucket.to(torch.int32) * (h * w) + cell.to(torch.int32)
    prob_sum = scatter.scatter_add(
        max_classes * h * w, flat, prob.reshape(-1), pmask
    ).reshape(max_classes, h, w)

    sem = up.semantic.clone()
    new = up.sem_new.clone()
    idm = up.id_max.clone()
    for lay in lays:
        # ties (an all-zero cell) take the first bucket, as jnp.argmax does
        best, arg = torch.max(prob_sum, dim=0)              # (H, W)
        new[lay] = best
        idm[lay] = uniq[arg]
        # zero the winner so the next layer takes the runner-up
        prob_sum = prob_sum.scatter(0, arg[None], 0.0)

    sem[lays] = _normalised(new[lays])
    return up._replace(semantic=sem, sem_new=new, id_max=idm)


def fuse_color(
    up: SemanticUpdate,
    assoc: PointAssociation,
    feats: torch.Tensor,     # (N, L) float-packed rgb
    layer_ids: Sequence[int],
    elev_cnt: torch.Tensor,
    cfg: MapConfig,
) -> SemanticUpdate:
    """pointcloud_color (pointcloud_color.py:120-152): unpack → mean → repack.

    The point count and every layer's r, g, b sums are integer streams of
    one K1 launch (1 + 3 L streams; exact below 2^24, so merging the JAX
    package's separate scatters changes no bit)."""
    h, w = up.semantic.shape[-2:]
    mask = assoc.valid & assoc.inside
    streams = [torch.ones(feats.shape[0], dtype=torch.float32, device=feats.device)]
    for k in range(len(layer_ids)):
        streams.extend(c.to(torch.float32) for c in rgb_float_to_uint(feats[:, k]))
    sums = scatter.scatter_add_streams_2d(h, w, assoc.flat_idx, streams, mask)
    cnt = sums[0]
    has = cnt > 0
    safe = torch.clamp(cnt, min=1.0)
    sem = up.semantic.clone()
    for k, lay in enumerate(layer_ids):
        # reference divides uint sums with integer division
        rm, gm, bm = (torch.floor(sums[1 + 3 * k + c] / safe).to(torch.int64) for c in range(3))
        sem[lay] = torch.where(has, uint_to_rgb_float(rm, gm, bm), sem[lay])
    return up._replace(semantic=sem)


# registry: fusion algorithm name -> implementation
POINTCLOUD_FUSIONS = {
    "average": fuse_average,
    "class_average": fuse_class_average,
    "bayesian_inference": fuse_bayesian_inference,
    "class_bayesian": fuse_class_bayesian,
    "class_max": fuse_class_max,
    "color": fuse_color,
}

# fusions whose sem_new accumulation buffer persists across updates
# (semantic_map.py:51-63 delete_new_layers)
PERSISTENT_NEW = ("class_bayesian", "class_max")
