"""DINO ViT feature extractor in PyTorch.

Re-derivation of the reference's vendored torch DINO stack
(semantic_sensor/DINO/vision_transformer.py + modules.py:6-126): a frozen
ViT backbone whose last-block tokens (or per-head keys, "KK") feed a
STEGO-style linear / nonlinear projection head producing dense per-pixel
feature maps for the MEM semantic layers.

The numbers are those of the JAX package's ``sensor/dino.py``:

  * every matmul and attention product rounds its operands to
    ``cfg.compute_dtype`` (bf16 by default) and sums float32 products into a
    float32 result (JAX's ``preferred_element_type=float32``); on the card
    that is one cuBLAS bf16 product with a float32 output, elsewhere the
    rounded operands are multiplied in float32. With ``compute_dtype``
    float32 the products are plain float32 (TF32 stays off, PyTorch's
    default);
  * patch embedding as a reshape + matmul (a stride-p conv with kernel p is
    a (p*p*3, D) product over non-overlapping patches);
  * attention as matmul + softmax + matmul, since ``vit_features`` returns
    the last block's attention matrix;
  * exact (erf) GELU, LayerNorm with eps 1e-6 and the population variance;
  * the pos-embed grid resized bilinearly with antialiasing when it shrinks
    (``jax.image.resize``'s triangle filter), half-pixel centres.

Weights: ``load_torch_checkpoint`` reads the public DINO .pth files
(facebook/dino naming); ``init_vit_params`` gives random weights from an
explicit ``torch.Generator``; ``params_from_jax`` carries the JAX package's
parameter tree (as NumPy arrays) into the modules.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..mapper import resolve_device

__all__ = [
    "VIT_VARIANTS",
    "ViTConfig",
    "DinoViT",
    "init_vit_params",
    "params_from_jax",
    "load_torch_checkpoint",
    "vit_features",
    "dino_featurize",
    "DinoFeaturizer",
]

VIT_VARIANTS = {
    # name: (embed_dim, depth, num_heads)
    "vit_tiny": (192, 12, 3),
    "vit_small": (384, 12, 6),
    "vit_base": (768, 12, 12),
}


class ViTConfig(NamedTuple):
    variant: str = "vit_small"
    patch_size: int = 8
    mlp_ratio: float = 4.0
    feat_type: str = "feat"           # "feat" | "KK"  (modules.py:103-109)
    projection_type: Optional[str] = "nonlinear"  # None | "linear" | "nonlinear"
    dim: int = 70                      # projection head output channels
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def embed_dim(self) -> int:
        return VIT_VARIANTS[self.variant][0]

    @property
    def depth(self) -> int:
        return VIT_VARIANTS[self.variant][1]

    @property
    def num_heads(self) -> int:
        return VIT_VARIANTS[self.variant][2]

    @property
    def n_feats(self) -> int:
        """Channel count of the dense feature map (modules.py:35-38,106-109):
        D for "feat", heads * head_dim = D for "KK"."""
        return self.embed_dim


@functools.lru_cache(maxsize=None)
def _has_out_dtype() -> bool:
    """Whether this torch has ``mm``/``bmm`` with ``out_dtype`` (a bf16
    product with a float32 output in one cuBLAS call)."""
    return "dtype" in torch.ops.aten.mm.overloads() and "dtype" in torch.ops.aten.bmm.overloads()


def _matmul(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a (..., M, K) @ b ((K, N) or (..., K, N)) with both operands rounded to
    ``dtype`` and a float32 result."""
    if dtype == torch.float32:
        return torch.matmul(a, b)
    a, b = a.to(dtype), b.to(dtype)
    if a.is_cuda and _has_out_dtype():
        if b.dim() == 2:
            out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
            return out.reshape(*a.shape[:-1], b.shape[-1])
        lead = a.shape[:-2]
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]), out_dtype=torch.float32)
        return out.reshape(*lead, a.shape[-2], b.shape[-1])
    # bf16 x bf16 products are exact in float32: only the summation order
    # can differ from the card's
    return torch.matmul(a.float(), b.float())


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return _matmul(x, layer.weight.t(), dtype) + layer.bias


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        """Returns (output, attention (B, H, N, N), keys (B, H, N, hd))."""
        b, n, d = x.shape
        hd = d // self.num_heads
        qkv = _linear(x, self.qkv, dtype).reshape(b, n, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = _matmul(q, k.transpose(-2, -1), dtype) * hd ** -0.5
        attn = torch.softmax(attn, dim=-1)
        out = _matmul(attn, v, dtype).transpose(1, 2).reshape(b, n, d)
        return _linear(out, self.proj, dtype), attn, k


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _linear(F.gelu(_linear(x, self.fc1, dtype)), self.fc2, dtype)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, hidden: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, hidden)

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        a_out, attn, keys = self.attn(self.norm1(x), dtype)
        x = x + a_out
        return x + self.mlp(self.norm2(x), dtype), attn, keys


class DinoViT(nn.Module):
    """The backbone (facebook/dino's module names, the patch embedding as a
    linear layer over flattened (3, p, p) patches) and the projection head
    (modules.py:44-72)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d, p = cfg.embed_dim, cfg.patch_size
        self.cfg = cfg
        self.patch_embed = nn.Linear(3 * p * p, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 197 if p == 16 else 785, d))
        self.blocks = nn.ModuleList(Block(d, cfg.num_heads, int(d * cfg.mlp_ratio)) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=1e-6)
        nf = cfg.n_feats
        self.cluster1 = nn.Linear(nf, cfg.dim)
        self.cluster2 = None
        if cfg.projection_type == "nonlinear":
            self.cluster2 = nn.Sequential(nn.Linear(nf, nf), nn.ReLU(), nn.Linear(nf, cfg.dim))
        self.requires_grad_(False)

    def forward(self, img: torch.Tensor):
        return dino_featurize(self, img, self.cfg)


def _interp_pos_embed(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """Bilinear pos-embed resize (vision_transformer.py
    interpolate_pos_encoding), antialiased where the grid shrinks."""
    n = pos.shape[1] - 1
    g0 = int(round(math.sqrt(n)))
    if g0 * g0 == n and (gh, gw) == (g0, g0):
        return pos
    d = pos.shape[-1]
    grid = pos[:, 1:].reshape(1, g0, g0, d).permute(0, 3, 1, 2)
    resized = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False, antialias=True)
    return torch.cat([pos[:, :1], resized.permute(0, 2, 3, 1).reshape(1, gh * gw, d)], dim=1)


@torch.no_grad()
def vit_features(
    model: DinoViT, img: torch.Tensor, cfg: Optional[ViTConfig] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the backbone on (B, 3, H, W) images; returns (tokens (B, 1+N, D)
    post-norm, last-block attention (B, H, 1+N, 1+N), last-block keys
    (B, H, 1+N, hd)), the ``get_intermediate_feat(n=1)`` surface the
    featurizer consumes. ``cfg`` defaults to the model's (pass one to change
    ``compute_dtype``)."""
    cfg = cfg or model.cfg
    b, c, h, w = img.shape
    p = cfg.patch_size
    gh, gw = h // p, w // p
    dtype = cfg.compute_dtype

    # patchify: (B, 3, H, W) -> (B, gh*gw, 3*p*p) with (3, p, p) patch layout
    x = img[:, :, : gh * p, : gw * p].reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    x = _linear(x.reshape(b, gh * gw, c * p * p), model.patch_embed, dtype)
    x = torch.cat([model.cls_token.expand(b, 1, x.shape[-1]), x], dim=1)
    x = x + _interp_pos_embed(model.pos_embed, gh, gw)

    attn = keys = None
    for blk in model.blocks:
        x, attn, keys = blk(x, dtype)
    return model.norm(x), attn, keys


@torch.no_grad()
def dino_featurize(
    model: DinoViT, img: torch.Tensor, cfg: Optional[ViTConfig] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DinoFeaturizer.forward equivalent (modules.py:74-126, inference path):
    returns (image_feat (B, n_feats, gh, gw), code (B, dim, gh, gw))."""
    cfg = cfg or model.cfg
    b, _, h, w = img.shape
    p = cfg.patch_size
    gh, gw = h // p, w // p
    tokens, _, keys = vit_features(model, img, cfg)

    if cfg.feat_type == "feat":
        feat = tokens[:, 1:, :]                      # (B, N, D)
    elif cfg.feat_type == "KK":
        # per-head keys of the patch tokens, heads*hd re-flattened
        feat = keys[:, :, 1:, :].transpose(1, 2).reshape(b, gh * gw, -1)
    else:
        raise ValueError(f"unknown feat_type {cfg.feat_type}")

    image_feat = feat.reshape(b, gh, gw, -1).permute(0, 3, 1, 2)
    if cfg.projection_type is None:
        return image_feat, image_feat
    dtype = cfg.compute_dtype
    code = _linear(feat, model.cluster1, dtype)
    if cfg.projection_type == "nonlinear":
        fc_a, _, fc_b = model.cluster2
        code = code + _linear(torch.relu(_linear(feat, fc_a, dtype)), fc_b, dtype)
    return image_feat, code.reshape(b, gh, gw, -1).permute(0, 3, 1, 2)


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(x, np.float32))


def params_from_jax(tree: Dict[str, Any], cfg: ViTConfig) -> DinoViT:
    """The JAX package's parameter tree (``init_vit_params`` or
    ``load_torch_checkpoint`` there, leaves as NumPy arrays; matmul weights
    laid out (in, out)) as a ``DinoViT`` on the CPU."""
    model = DinoViT(cfg)

    def linear(layer: nn.Linear, w, b):
        layer.weight.copy_(_tensor(w).t())
        layer.bias.copy_(_tensor(b))

    def norm(layer: nn.LayerNorm, scale, bias):
        layer.weight.copy_(_tensor(scale))
        layer.bias.copy_(_tensor(bias))

    with torch.no_grad():
        if len(tree["blocks"]) != cfg.depth or tuple(np.shape(tree["patch_w"])) != tuple(model.patch_embed.weight.t().shape):
            raise ValueError(f"the parameter tree does not fit {cfg.variant} with patch {cfg.patch_size}")
        linear(model.patch_embed, tree["patch_w"], tree["patch_b"])
        model.cls_token.copy_(_tensor(tree["cls_token"]))
        model.pos_embed.data = _tensor(tree["pos_embed"]).clone()
        norm(model.norm, tree["norm_scale"], tree["norm_bias"])
        for blk, src in zip(model.blocks, tree["blocks"]):
            norm(blk.norm1, src["ln1_scale"], src["ln1_bias"])
            linear(blk.attn.qkv, src["qkv_w"], src["qkv_b"])
            linear(blk.attn.proj, src["proj_w"], src["proj_b"])
            norm(blk.norm2, src["ln2_scale"], src["ln2_bias"])
            linear(blk.mlp.fc1, src["fc1_w"], src["fc1_b"])
            linear(blk.mlp.fc2, src["fc2_w"], src["fc2_b"])
        linear(model.cluster1, tree["cluster1_w"], tree["cluster1_b"])
        if model.cluster2 is not None:
            linear(model.cluster2[0], tree["cluster2a_w"], tree["cluster2a_b"])
            linear(model.cluster2[2], tree["cluster2b_w"], tree["cluster2b_b"])
    return model


def _trunc_normal(gen: torch.Generator, shape, std: float = 0.02) -> torch.Tensor:
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=gen)
    return t


def _random_tree(gen: torch.Generator, cfg: ViTConfig) -> Dict[str, Any]:
    """A parameter tree in the JAX package's layout: matmul weights from a
    normal truncated at 2 sigma (sigma 0.02), biases 0, LayerNorm scales 1,
    drawn in the JAX package's order."""
    d, depth, _ = VIT_VARIANTS[cfg.variant]
    p = cfg.patch_size
    hidden = int(d * cfg.mlp_ratio)
    tree: Dict[str, Any] = {
        "patch_w": _trunc_normal(gen, (p * p * 3, d)),
        "patch_b": torch.zeros(d),
        "cls_token": _trunc_normal(gen, (1, 1, d)),
        "pos_embed": _trunc_normal(gen, (1, 197 if p == 16 else 785, d)),
        "norm_scale": torch.ones(d),
        "norm_bias": torch.zeros(d),
        "blocks": [],
    }
    for _ in range(depth):
        tree["blocks"].append({
            "ln1_scale": torch.ones(d), "ln1_bias": torch.zeros(d),
            "qkv_w": _trunc_normal(gen, (d, 3 * d)), "qkv_b": torch.zeros(3 * d),
            "proj_w": _trunc_normal(gen, (d, d)), "proj_b": torch.zeros(d),
            "ln2_scale": torch.ones(d), "ln2_bias": torch.zeros(d),
            "fc1_w": _trunc_normal(gen, (d, hidden)), "fc1_b": torch.zeros(hidden),
            "fc2_w": _trunc_normal(gen, (hidden, d)), "fc2_b": torch.zeros(d),
        })
    nf = cfg.n_feats
    tree["cluster1_w"] = _trunc_normal(gen, (nf, cfg.dim))
    tree["cluster1_b"] = torch.zeros(cfg.dim)
    if cfg.projection_type == "nonlinear":
        tree["cluster2a_w"] = _trunc_normal(gen, (nf, nf))
        tree["cluster2a_b"] = torch.zeros(nf)
        tree["cluster2b_w"] = _trunc_normal(gen, (nf, cfg.dim))
        tree["cluster2b_b"] = torch.zeros(cfg.dim)
    return tree


def init_vit_params(generator: torch.Generator, cfg: ViTConfig) -> DinoViT:
    """Random weights from ``generator`` (a CPU ``torch.Generator``), as a
    ``DinoViT`` on the CPU."""
    return params_from_jax(_random_tree(generator, cfg), cfg)


def load_torch_checkpoint(path: str, cfg: ViTConfig, generator: Optional[torch.Generator] = None) -> DinoViT:
    """Read a public DINO ``.pth`` state dict (facebook/dino naming) into a
    ``DinoViT`` on the CPU. The projection head (not part of the DINO
    release) is random, drawn from ``generator`` (seed 0 without one)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    d, p = cfg.embed_dim, cfg.patch_size
    tree = _random_tree(generator if generator is not None else torch.Generator().manual_seed(0), cfg)

    def t(name):
        return sd[name].float()

    # conv (D, 3, p, p) -> (3*p*p, D) product over flattened (3, p, p) patches
    tree["patch_w"] = t("patch_embed.proj.weight").reshape(d, 3 * p * p).t()
    tree["patch_b"] = t("patch_embed.proj.bias")
    tree["cls_token"] = t("cls_token")
    tree["pos_embed"] = t("pos_embed")
    tree["norm_scale"] = t("norm.weight")
    tree["norm_bias"] = t("norm.bias")
    for i, blk in enumerate(tree["blocks"]):
        pre = f"blocks.{i}."
        blk["ln1_scale"] = t(pre + "norm1.weight")
        blk["ln1_bias"] = t(pre + "norm1.bias")
        blk["qkv_w"] = t(pre + "attn.qkv.weight").t()
        blk["qkv_b"] = t(pre + "attn.qkv.bias")
        blk["proj_w"] = t(pre + "attn.proj.weight").t()
        blk["proj_b"] = t(pre + "attn.proj.bias")
        blk["ln2_scale"] = t(pre + "norm2.weight")
        blk["ln2_bias"] = t(pre + "norm2.bias")
        blk["fc1_w"] = t(pre + "mlp.fc1.weight").t()
        blk["fc1_b"] = t(pre + "mlp.fc1.bias")
        blk["fc2_w"] = t(pre + "mlp.fc2.weight").t()
        blk["fc2_b"] = t(pre + "mlp.fc2.bias")
    return params_from_jax(tree, cfg)


class DinoFeaturizer:
    """Stateful wrapper with the sensor-registry ``predict`` interface.

    predict(image (3, H, W) uint8) -> {channel: (H, W) float32 host array};
    features are bilinearly upsampled back to pixel resolution like the
    reference pointcloud node does before back-projection. The network runs
    on ``device`` (CUDA unless ``device="cpu"``; without a card that raises).
    """

    IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
    IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

    def __init__(
        self,
        channels=None,
        cfg: ViTConfig = None,
        weight_file: Optional[str] = None,
        seed: int = 0,
        device: Union[None, str, torch.device] = None,
    ):
        self.cfg = cfg or ViTConfig()
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        if weight_file:
            model = load_torch_checkpoint(weight_file, self.cfg, gen)
        else:
            model = init_vit_params(gen, self.cfg)
        self.model = model.to(self.device).eval()
        n_out = self.cfg.dim if self.cfg.projection_type else self.cfg.n_feats
        self.channels = list(channels) if channels else [
            f"feat_{i}" for i in range(min(n_out, 16))
        ]
        if len(self.channels) > n_out:
            raise ValueError(
                f"{len(self.channels)} channels requested but the head emits "
                f"only {n_out} feature dims ({self.cfg.variant}, "
                f"projection_type={self.cfg.projection_type!r})"
            )

    @torch.no_grad()
    def predict(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        img = np.asarray(image, np.float32) / 255.0
        img = (img - self.IMAGENET_MEAN[:, None, None]) / self.IMAGENET_STD[:, None, None]
        c, h, w = img.shape
        p = self.cfg.patch_size
        x = torch.from_numpy(np.ascontiguousarray(img[None, :, : (h // p) * p, : (w // p) * p])).to(self.device)
        _, code = dino_featurize(self.model, x, self.cfg)
        code = F.interpolate(code, size=(h, w), mode="bilinear", align_corners=False)
        code = code[0, : len(self.channels)].cpu().numpy()
        return {name: code[i] for i, name in enumerate(self.channels)}
