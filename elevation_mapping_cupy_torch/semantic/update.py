"""Semantic layer update orchestration (SemanticMap equivalent).

PyTorch counterpart of ``elevation_mapping_cupy_tpu/semantic/update.py``
(reference SemanticMap.update_layers_pointcloud, semantic_map.py:223-259):
the channel list resolves to (feature column, layer, fusion) triples on the
host, and each fusion present runs once over all of its layers.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..config import MapConfig
from ..ops.geometry import PointAssociation
from .fusions import PERSISTENT_NEW, POINTCLOUD_FUSIONS, SemanticUpdate

__all__ = ["resolve_channels", "persistent_mask", "reset_sem_new", "update_semantic_pointcloud"]


def resolve_channels(channels: Sequence[str], cfg: MapConfig, kind: str = "pointcloud"):
    """channel name -> (feature column, semantic layer index, fusion algo).

    Channels that resolve to no fusion are skipped with the same semantics as
    the reference's warning path (semantic_map.py:158-167). Channels must
    already exist in cfg.semantic_layers (the stateful wrapper grows the
    config for unseen channels, mirroring dynamic add_layer).
    """
    resolved = []
    for col, ch in enumerate(channels):
        fusion = cfg.fusion_for_channel(ch, kind)
        if fusion is None:
            continue
        if ch not in cfg.semantic_layers:
            raise ValueError(
                f"channel {ch!r} not in cfg.semantic_layers; grow the config first"
            )
        resolved.append((col, cfg.semantic_layers.index(ch), fusion))
    return resolved


def persistent_mask(cfg: MapConfig) -> Tuple[bool, ...]:
    """Per-layer: does sem_new persist across updates (delete_new_layers=0)?

    Intentionally resolved through the POINTCLOUD fusion table for both
    paths: the reference's initialize_fusion flips delete_new_layers only
    from layer_specs_points (semantic_map.py:52-61), so image-path resets
    follow the pointcloud persistence decision there too."""
    out = []
    for name in cfg.semantic_layers:
        fusion = cfg.fusion_for_channel(name, "pointcloud")
        out.append(fusion in PERSISTENT_NEW)
    return tuple(out)


def reset_sem_new(sem_new: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Zero the per-update accumulators, except the persistent rows
    (Dirichlet alpha, class-max sums), which are left bit for bit.
    ``sem_new`` is (..., S, H, W), leading axes a batch of maps."""
    rows = [i for i, keep in enumerate(persistent_mask(cfg)) if not keep]
    if not rows or sem_new.shape[-3] == 0:
        return sem_new
    out = sem_new.clone()
    for i in rows:
        out[..., i, :, :] = 0.0
    return out


def update_semantic_pointcloud(
    semantic: torch.Tensor,
    sem_new: torch.Tensor,
    id_max: torch.Tensor,
    assoc: PointAssociation,
    features: torch.Tensor,       # (N, C) semantic channels (columns of the cloud)
    channels: Tuple[str, ...],    # channel names, len C
    elev_cnt: torch.Tensor,       # (H, W) elevation newmap count
    cfg: MapConfig,
    id_union: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply every applicable fusion for one pointcloud; returns updated
    (semantic, sem_new, id_max). The layers may be a block of a sharded map
    (with an association made for it); ``id_union`` then joins class_max's
    class ids over the processes (``fusions.fuse_class_max``)."""
    if semantic.shape[0] == 0 or len(channels) == 0:
        return semantic, sem_new, id_max

    up = SemanticUpdate(semantic=semantic, sem_new=reset_sem_new(sem_new, cfg), id_max=id_max)
    resolved = resolve_channels(channels, cfg, "pointcloud")
    for fusion in sorted({f for _, _, f in resolved}):
        fn = POINTCLOUD_FUSIONS.get(fusion)
        if fn is None:
            continue
        if fusion == "class_max" and id_union is not None:
            fn = functools.partial(fn, id_union=id_union)
        cols = [c for c, _, f in resolved if f == fusion]
        lays = [l for _, l, f in resolved if f == fusion]
        feats = torch.stack([features[:, c] for c in cols], dim=1)
        up = fn(up, assoc, feats, lays, elev_cnt, cfg)
    return up.semantic, up.sem_new, up.id_max
