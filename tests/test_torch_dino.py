"""The port's DINO ViT featurizer (``sensor/dino.py``) and the model
registry against the JAX package, on the CPU.

Mirrors tests/test_dino.py. ``params_from_jax`` carries JAX's
``init_vit_params(PRNGKey(7))`` into the port's modules, so both packages
compute the same function of the same seeded images (vit_tiny, patch 8):

* ``compute_dtype`` float32: tokens, keys, attention and code within 1e-4;
* the default bf16: code within 5e-3, tokens within 2e-2 (and 3e-3 on
  average). Each matmul rounds its operands to bf16 and sums float32
  products; the two packages add those products in another order, which
  moves a value across a bf16 rounding boundary now and then, and twelve
  blocks amplify that. JAX's own bf16-against-float32 gap on the same
  inputs is 1.5e-2 to 2.3e-2 on tokens.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elevation_mapping_cupy_tpu.sensor import dino as J
from elevation_mapping_cupy_tpu.sensor import networks as jnetworks

from elevation_mapping_cupy_torch.sensor import dino as T
from elevation_mapping_cupy_torch.sensor import networks

SHAPES = [(32, 32), (64, 48), (240, 16)]  # pos-embed grid shrinks; shrinks; grows in H and shrinks in W


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def cfgs(dtype: str, **kw):
    kw = {"variant": "vit_tiny", "patch_size": 8, "dim": 12, **kw}
    return (J.ViTConfig(compute_dtype=getattr(jnp, dtype), **kw),
            T.ViTConfig(compute_dtype=getattr(torch, dtype), **kw))


@pytest.fixture(scope="module")
def jax_params():
    return J.init_vit_params(jax.random.PRNGKey(7), cfgs("float32")[0])


@pytest.fixture(scope="module")
def model(jax_params):
    return T.params_from_jax(jax.tree.map(np.asarray, jax_params), cfgs("float32")[1])


def image(shape, seed=0, b=1):
    return np.random.default_rng(seed).standard_normal((b, 3) + shape).astype(np.float32)


def close(got, want, atol, mean=None):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want)
    assert diff.max() <= atol, f"max {diff.max()} > {atol}"
    if mean is not None:
        assert diff.mean() <= mean, f"mean {diff.mean()} > {mean}"


@pytest.mark.parametrize("shape", SHAPES)
def test_float32_matches_jax(jax_params, model, shape):
    jcfg, tcfg = cfgs("float32")
    img = image(shape)
    jt, ja, jk = J.vit_features(jax_params, jnp.asarray(img), jcfg)
    tt, ta, tk = T.vit_features(model, torch.from_numpy(img), tcfg)
    for got, want in ((tt, jt), (ta, ja), (tk, jk)):
        close(got, want, 1e-4)
    jf, jc = J.dino_featurize(jax_params, jnp.asarray(img), jcfg)
    tf, tc = T.dino_featurize(model, torch.from_numpy(img), tcfg)
    close(tf, jf, 1e-4)
    close(tc, jc, 1e-4)
    gh, gw = shape[0] // 8, shape[1] // 8
    assert ta.shape == (1, tcfg.num_heads, 1 + gh * gw, 1 + gh * gw)
    torch.testing.assert_close(ta.sum(-1), torch.ones(ta.shape[:-1]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_matches_jax(jax_params, model, shape):
    jcfg, tcfg = cfgs("bfloat16")
    img = image(shape)
    jt, _, _ = J.vit_features(jax_params, jnp.asarray(img), jcfg)
    tt, _, _ = T.vit_features(model, torch.from_numpy(img), tcfg)
    close(tt, jt, 2e-2, mean=3e-3)
    _, jc = J.dino_featurize(jax_params, jnp.asarray(img), jcfg)
    _, tc = T.dino_featurize(model, torch.from_numpy(img), tcfg)
    close(tc, jc, 5e-3)
    assert model.cfg.compute_dtype == torch.float32  # the cfg argument, not the model's, set the dtype


@pytest.mark.parametrize("grid", [(4, 4), (8, 6), (30, 2), (36, 40), (28, 28), (2, 1)])
def test_pos_embed_resize_matches_jax(grid):
    """The 28x28 pos-embed grid of patch 8 resized both ways: shrinking
    antialiases like jax.image.resize, growing is half-pixel bilinear."""
    pos = np.random.default_rng(3).standard_normal((1, 785, 24)).astype(np.float32)
    got = T._interp_pos_embed(torch.from_numpy(pos), *grid)
    want = J._interp_pos_embed(jnp.asarray(pos), *grid)
    close(got, want, 1e-5)


def test_featurize_shapes_and_determinism(model):
    _, tcfg = cfgs("float32")
    img = torch.from_numpy(image((24, 40), seed=1, b=2))
    feat, code = T.dino_featurize(model, img, tcfg)
    assert feat.shape == (2, tcfg.n_feats, 3, 5) and code.shape == (2, tcfg.dim, 3, 5)
    feat2, code2 = model(img)
    torch.testing.assert_close(code2, code, rtol=0, atol=0)
    assert not code.requires_grad


@pytest.mark.parametrize("projection", ["KK", None, "linear"])
def test_feat_type_and_projection_variants(jax_params, projection):
    """The "KK" feature type (per-head keys) and the heads without the
    nonlinear branch, against JAX."""
    kw = {"feat_type": "KK"} if projection == "KK" else {"projection_type": projection}
    jcfg, tcfg = cfgs("float32", **kw)
    m = T.params_from_jax(jax.tree.map(np.asarray, jax_params), tcfg)
    img = image((16, 24), seed=4)
    jf, jc = J.dino_featurize(jax_params, jnp.asarray(img), jcfg)
    tf, tc = T.dino_featurize(m, torch.from_numpy(img), tcfg)
    assert tf.shape == (1, tcfg.embed_dim, 2, 3)
    close(tf, jf, 1e-4)
    close(tc, jc, 1e-4)


def test_featurizer_predict_matches_jax(jax_params):
    """predict: channels, (H, W) host float32 maps upsampled from the patch
    grid (an image not divisible by the patch is cropped first); with the
    JAX featurizer's weights, its maps within 1e-4."""
    jcfg, tcfg = cfgs("float32", dim=4)
    jf = J.DinoFeaturizer(channels=["f0", "f1"], cfg=jcfg)
    f = T.DinoFeaturizer(channels=["f0", "f1"], cfg=tcfg, device="cpu")
    f.model = T.params_from_jax(jax.tree.map(np.asarray, jf.params), tcfg)
    img = np.random.default_rng(2).integers(0, 255, (3, 33, 47), np.uint8)
    out, jout = f.predict(img), jf.predict(img)
    assert set(out) == {"f0", "f1"}
    for name in out:
        assert out[name].shape == (33, 47) and out[name].dtype == np.float32
        np.testing.assert_allclose(out[name], jout[name], rtol=0, atol=1e-4)
    assert T.DinoFeaturizer(cfg=tcfg, device="cpu").channels == ["feat_0", "feat_1", "feat_2", "feat_3"]
    with pytest.raises(ValueError, match="channels requested"):
        T.DinoFeaturizer(channels=[f"c{i}" for i in range(5)], cfg=tcfg, device="cpu")


def test_init_vit_params_is_seeded():
    """init_vit_params draws from the generator it is given: the same seed
    gives the same weights, another seed others; matmul weights lie within
    2 sigma (0.04), biases are 0 and LayerNorm scales 1."""
    _, tcfg = cfgs("float32")
    a = T.init_vit_params(torch.Generator().manual_seed(5), tcfg)
    b = T.init_vit_params(torch.Generator().manual_seed(5), tcfg)
    c = T.init_vit_params(torch.Generator().manual_seed(6), tcfg)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["blocks.0.attn.qkv.weight"], sc["blocks.0.attn.qkv.weight"])
    w = sa["blocks.3.mlp.fc1.weight"]
    assert w.abs().max() <= 0.04 and 0.01 < float(w.std()) < 0.02
    assert not sa["blocks.3.mlp.fc1.bias"].any() and torch.equal(sa["norm.weight"], torch.ones(192))


def test_load_torch_checkpoint_matches_jax(tmp_path, jax_params):
    """A facebook/dino-named state dict (made from the JAX tree, conv patch
    embedding) read by both packages computes the same tokens."""
    jcfg, tcfg = cfgs("float32")
    p = {k: np.array(v) for k, v in jax_params.items() if k != "blocks"}
    d = tcfg.embed_dim
    sd = {
        "patch_embed.proj.weight": torch.from_numpy(p["patch_w"].T.reshape(d, 3, 8, 8).copy()),
        "patch_embed.proj.bias": torch.from_numpy(p["patch_b"]),
        "cls_token": torch.from_numpy(p["cls_token"]), "pos_embed": torch.from_numpy(p["pos_embed"]),
        "norm.weight": torch.from_numpy(p["norm_scale"]), "norm.bias": torch.from_numpy(p["norm_bias"]),
    }
    names = {"ln1": "norm1", "ln2": "norm2", "qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i, blk in enumerate(jax_params["blocks"]):
        for short, full in names.items():
            if short.startswith("ln"):
                sd[f"blocks.{i}.{full}.weight"] = torch.from_numpy(np.array(blk[f"{short}_scale"]))
                sd[f"blocks.{i}.{full}.bias"] = torch.from_numpy(np.array(blk[f"{short}_bias"]))
            else:
                sd[f"blocks.{i}.{full}.weight"] = torch.from_numpy(np.array(blk[f"{short}_w"]).T.copy())
                sd[f"blocks.{i}.{full}.bias"] = torch.from_numpy(np.array(blk[f"{short}_b"]))
    path = str(tmp_path / "dino.pth")
    torch.save({"state_dict": sd}, path)
    m = T.load_torch_checkpoint(path, tcfg, torch.Generator().manual_seed(0))
    jp = J.load_torch_checkpoint(path, jcfg, jax.random.PRNGKey(0))
    img = image((32, 24), seed=5)
    close(T.vit_features(m, torch.from_numpy(img), tcfg)[0], J.vit_features(jp, jnp.asarray(img), jcfg)[0], 1e-4)
    close(T.vit_features(m, torch.from_numpy(img), tcfg)[0], J.vit_features(jax_params, jnp.asarray(img), jcfg)[0], 1e-4)


def test_registry_resolves_dino():
    m = networks.resolve_model("dino_vits16", channels=["a"], device="cpu")
    assert isinstance(m, T.DinoFeaturizer) and m.cfg.patch_size == 16 and m.cfg.variant == "vit_small"
    assert m.channels == ["a"] and m.device.type == "cpu"
    assert set(networks.MODELS) == set(jnetworks.MODELS)


def test_registry_detectron_gated_fallback(monkeypatch):
    """Without detectron2 the panoptic entry degrades to the deterministic
    fallback (same channels), as in JAX; the package is masked so that no
    model-zoo weights are ever fetched."""
    monkeypatch.setitem(sys.modules, "detectron2", None)  # force ImportError
    assert "detectron_coco_panoptic_fpn_R_101_3x" in networks.MODELS
    with pytest.warns(UserWarning, match="random_features"):
        m = networks.resolve_model("detectron_coco_panoptic_fpn_R_101_3x", channels=["person", "grass"], device="cpu")
    out = m.predict(np.zeros((3, 16, 16), np.uint8))
    assert set(out) == {"person", "grass"}


def test_registry_torchvision_missing_falls_back(monkeypatch, rng):
    """A missing torchvision degrades to random features, equal to the JAX
    package's fallback on the same image."""
    monkeypatch.setitem(sys.modules, "torchvision", None)
    with pytest.warns(UserWarning, match="random_features"):
        m = networks.resolve_model("lraspp_mobilenet_v3_large", channels=["grass", "person"], device="cpu")
    with pytest.warns(UserWarning):
        jm = jnetworks.resolve_model("lraspp_mobilenet_v3_large", channels=["grass", "person"])
    img = rng.integers(0, 255, (3, 20, 24), np.uint8)
    out, jout = m.predict(img), jm.predict(img)
    assert set(out) == {"grass", "person"}
    for k in out:
        np.testing.assert_array_equal(out[k], jout[k])


@pytest.mark.parametrize("error", [RuntimeError("CUDA error: an illegal memory access was encountered"),
                                   torch.cuda.OutOfMemoryError("CUDA out of memory"), ValueError("bad argument")])
def test_model_errors_propagate(monkeypatch, error):
    """Only a missing package or weight file degrades; a RuntimeError (on the
    card: a CUDA or out-of-memory error) propagates out of resolve_model."""
    def broken(**kw):
        raise error

    monkeypatch.setitem(networks.MODELS, "broken", broken)
    with pytest.raises(type(error)):
        networks.resolve_model("broken", channels=["a"], device="cpu")
    monkeypatch.setitem(networks.MODELS, "missing", lambda **kw: (_ for _ in ()).throw(OSError("no weight file")))
    with pytest.warns(UserWarning):
        assert isinstance(networks.resolve_model("missing", channels=["a"]), networks._RandomFeatures)


def test_sensor_to_map_matches_jax(jax_params):
    """The slice as a whole: a depth+rgb frame through PointcloudSensorNode
    with the DINO featurizer (the JAX node's weights) into a MappingService
    whose channels fuse by class_average, against the JAX package end to
    end: the clouds within 1e-4 (packed colour bit for bit), the fused
    layers within 1e-4."""
    from elevation_mapping_cupy_tpu import MapConfig as JaxConfig
    from elevation_mapping_cupy_tpu.runtime import service as jservice
    from elevation_mapping_cupy_tpu.sensor.pointcloud import PointcloudParameter as JParam
    from elevation_mapping_cupy_tpu.sensor.pointcloud import PointcloudSensorNode as JNode

    from elevation_mapping_cupy_torch import MapConfig
    from elevation_mapping_cupy_torch.runtime import service
    from elevation_mapping_cupy_torch.sensor.pointcloud import PointcloudParameter, PointcloudSensorNode

    jcfg, tcfg = cfgs("float32", dim=4)
    chans = ("feat_0", "feat_1", "feat_2")
    jnode = JNode(JParam(channels=chans))
    jnode.model = J.DinoFeaturizer(channels=list(chans), cfg=jcfg)
    node = PointcloudSensorNode(PointcloudParameter(channels=chans), device="cpu")
    node.model = T.DinoFeaturizer(channels=list(chans), cfg=tcfg, device="cpu")
    node.model.model = T.params_from_jax(jax.tree.map(np.asarray, jnode.model.params), tcfg)

    rng = np.random.default_rng(11)
    H, W = 40, 48
    depth = rng.uniform(0.8, 1.2, (H, W)).astype(np.float32)
    rgb = rng.integers(0, 256, (3, H, W)).astype(np.uint8)
    K = np.array([[40, 0, W / 2], [0, 40, H / 2], [0, 0, 1]], np.float32)
    cloud, names = node(depth, K, rgb=rgb)
    jcloud, jnames = jnode(depth, K, rgb=rgb)
    assert names == jnames == ["x", "y", "z", "rgb", *chans]
    np.testing.assert_array_equal(cloud[:, :4].view(np.uint32), jcloud[:, :4].view(np.uint32))
    np.testing.assert_allclose(cloud[:, 4:], jcloud[:, 4:], rtol=0, atol=1e-4)

    kw = dict(resolution=0.1, map_length=2.0, max_ray_length=0.5, max_points=2048,
              pointcloud_channel_fusions=(("rgb", "color"), ("default", "class_average")))
    jsvc = jservice.MappingService(JaxConfig(**kw))
    tsvc = service.MappingService(MapConfig(**kw), device="cpu")
    R_cam = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    for pkg, svc, c in ((jservice, jsvc, jcloud), (service, tsvc, cloud)):
        svc.enqueue(pkg.SensorFrame(kind="pointcloud", channels=tuple(names), data=c, R=R_cam,
                                    t=np.array([0, 0, 1.0], np.float32)))
        assert svc.spin_once() == 1
    layers = ["elevation", "is_valid", "rgb", *chans]
    got, want = tsvc.mapper.get_layers(layers), jsvc.mapper.get_layers(layers)
    np.testing.assert_array_equal(got["rgb"].view(np.uint32), want["rgb"].view(np.uint32))
    for name in layers[:2] + list(chans):
        np.testing.assert_array_equal(np.isnan(got[name]), np.isnan(want[name]))
        np.testing.assert_allclose(np.nan_to_num(got[name]), np.nan_to_num(want[name]), rtol=0, atol=1e-4)
    assert np.count_nonzero(got["feat_0"]) > 50


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert T.DinoFeaturizer(cfg=cfgs("float32")[1]).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.DinoFeaturizer(cfg=cfgs("float32")[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        networks.resolve_model("dino_vits16")
