"""Semantic segmentation / feature extractor registry (networks.py equivalent).

Mirrors the reference sidecar's `resolve_model` registry
(semantic_sensor/networks.py:32-136): torchvision segmentation backbones,
detectron2's panoptic FPN and the DINO ViT featurizers. Every network runs
on the ``device`` it is given (CUDA unless ``device="cpu"``).

A model whose package or weight file is missing (ImportError, OSError)
degrades to a deterministic fallback so the pipeline stays runnable
end-to-end; any other error, a CUDA or out-of-memory ``RuntimeError``
included, propagates: a failing card must not turn into a silently wrong
semantic map.

All models expose:  predict(image (3, H, W) uint8) -> dict[channel, (H, W)]
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..mapper import resolve_device
from .utils import encode_max

__all__ = ["resolve_model", "MODELS"]

VOC_CLASSES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


class _TorchvisionSeg:
    def __init__(self, arch: str, channels: Sequence[str], pretrained: bool = True, device=None):
        import torchvision

        self.device = resolve_device(device)
        ctor = getattr(torchvision.models.segmentation, arch)
        self.model = ctor(weights="DEFAULT" if pretrained else None).eval().to(self.device)
        self.channels = list(channels)
        self.class_ids = [VOC_CLASSES.index(c) if c in VOC_CLASSES else -1 for c in channels]

    def predict(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        x = torch.from_numpy(np.ascontiguousarray(image)).to(self.device).float() / 255.0
        mean = torch.tensor([0.485, 0.456, 0.406], device=self.device).view(3, 1, 1)
        std = torch.tensor([0.229, 0.224, 0.225], device=self.device).view(3, 1, 1)
        x = ((x - mean) / std)[None]
        with torch.no_grad():
            out = self.model(x)["out"][0].softmax(0).cpu().numpy()
        result = {}
        for name, cid in zip(self.channels, self.class_ids):
            if cid >= 0:
                result[name] = out[cid]
        # class_max packed channel
        best = out.argmax(0).astype(np.uint32)
        prob = out.max(0)
        result["max_class"] = encode_max(prob, best)
        return result


class _RandomFeatures:
    """Deterministic fallback feature extractor (DINO-style interface) for
    environments without torch weights; hash-based per-pixel features."""

    def __init__(self, channels: Sequence[str], seed: int = 0):
        self.channels = list(channels) or ["feat_0"]
        self.seed = seed

    def predict(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        img = image.astype(np.float32) / 255.0
        gray = img.mean(0)
        gx = np.gradient(gray, axis=1)
        gy = np.gradient(gray, axis=0)
        dc = gray - gray.mean()
        return {
            name: np.tanh((k + 1) * gx + k * gy + dc)
            for k, name in enumerate(self.channels)
        }


class _Detectron2Panoptic:
    """COCO panoptic FPN (reference networks.py:66-243 DetectronModel).

    Stuff channels come from the semantic head's softmax; thing channels are
    instance masks scaled by detection score (networks.py:223-242). Requires
    detectron2 — environments without it fall back via resolve_model.
    """

    def __init__(self, channels: Sequence[str], weights: str = "COCO-PanopticSegmentation/panoptic_fpn_R_101_3x.yaml",
                 device=None):
        from detectron2 import model_zoo
        from detectron2.config import get_cfg
        from detectron2.data import MetadataCatalog
        from detectron2.engine import DefaultPredictor

        cfg = get_cfg()
        cfg.merge_from_file(model_zoo.get_config_file(weights))
        cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.5
        cfg.MODEL.WEIGHTS = model_zoo.get_checkpoint_url(weights)
        cfg.MODEL.DEVICE = str(resolve_device(device))
        self.predictor = DefaultPredictor(cfg)
        meta = MetadataCatalog.get(cfg.DATASETS.TRAIN[0])
        stuff = {c: i for i, c in enumerate(meta.get("stuff_classes"))}
        thing = {c: i for i, c in enumerate(meta.get("thing_classes"))}
        # channel → (kind, class index); unknown channels are dropped, like
        # the reference's segmentation_channels resolution (networks.py:192-200)
        self.resolved = {}
        for c in channels:
            if c in stuff:
                self.resolved[c] = ("stuff", stuff[c])
            elif c in thing:
                self.resolved[c] = ("thing", thing[c])
        self.channels = list(self.resolved)

    def predict(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        bgr = np.ascontiguousarray(image[::-1].transpose(1, 2, 0))  # reference flips RGB→BGR
        pred = self.predictor(bgr)
        sem = torch.softmax(pred["sem_seg"], dim=0).cpu().numpy()
        seg_ids, instances = pred["panoptic_seg"]
        seg_ids = seg_ids.cpu().numpy()
        out: Dict[str, np.ndarray] = {}
        for name, (kind, cid) in self.resolved.items():
            if kind == "stuff":
                out[name] = sem[cid]
            else:
                acc = np.zeros(seg_ids.shape, np.float32)
                for inst in instances or []:
                    if inst and inst.get("isthing") and inst.get("category_id") == cid:
                        acc = np.maximum(acc, (seg_ids == inst["id"]) * float(inst.get("score", 1.0)))
                out[name] = acc
        return out


def _dino(variant: str, patch: int):
    def ctor(channels=None, weight_file=None, **kw):
        from .dino import DinoFeaturizer, ViTConfig

        return DinoFeaturizer(
            channels=channels,
            cfg=ViTConfig(variant=variant, patch_size=patch),
            weight_file=weight_file,
            **kw,
        )

    return ctor


MODELS: Dict[str, Callable[..., object]] = {
    "fcn_resnet50": lambda channels=VOC_CLASSES[1:], **kw: _TorchvisionSeg("fcn_resnet50", channels, **kw),
    "lraspp_mobilenet_v3_large": lambda channels=VOC_CLASSES[1:], **kw: _TorchvisionSeg("lraspp_mobilenet_v3_large", channels, **kw),
    "deeplabv3_resnet50": lambda channels=VOC_CLASSES[1:], **kw: _TorchvisionSeg("deeplabv3_resnet50", channels, **kw),
    # DINO ViT featurizers (sensor/dino.py); pass weight_file= to load
    # the public facebook/dino .pth checkpoints
    "dino_vits8": _dino("vit_small", 8),
    "dino_vits16": _dino("vit_small", 16),
    "dino_vitb8": _dino("vit_base", 8),
    "dino_vitb16": _dino("vit_base", 16),
    "detectron_coco_panoptic_fpn_R_101_3x": lambda channels=("person", "grass"), **kw: _Detectron2Panoptic(channels, **kw),
    "random_features": lambda channels=("feat_0",), **kw: _RandomFeatures(channels),
}


def resolve_model(name: str, channels: Optional[Sequence[str]] = None, **kw):
    """Instantiate a registered model (``device=`` among ``kw``); falls back
    to random features only when a package or a weight file is missing."""
    ctor = MODELS.get(name)
    if ctor is None:
        raise ValueError(f"unknown model {name!r}; have {sorted(MODELS)}")
    try:
        return ctor(channels=channels, **kw) if channels else ctor(**kw)
    except (ImportError, ModuleNotFoundError, OSError) as e:
        # a missing package or weight file degrades to the deterministic
        # fallback; everything else propagates: programming errors
        # (TypeError, ValueError) and RuntimeError, which on the card is a
        # CUDA or out-of-memory error
        warnings.warn(
            f"[sensor.networks] {name} unavailable ({e!r}); using random_features"
        )
        return _RandomFeatures(channels or ("feat_0",))
