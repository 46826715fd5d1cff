"""The port's runtime service, native sensor frontend and sensor sidecar nodes
against the JAX package, on the CPU.

Mirrors tests/test_runtime.py: the same seeded frames go through the JAX
package's ``MappingService`` and the port's (``device="cpu"``, where K1 runs
its plain version). Exported layers agree within 1e-4 on jointly finite
cells with equal NaN patterns; packed layers, statistics counts and submap
cell windows are equal; the native deinterleave and rgb packing equal their
NumPy plain versions and the JAX package's bit for bit.
"""

import os
import threading

import numpy as np
import pytest
import torch

from tests import torch_scenes
from elevation_mapping_cupy_tpu import MapConfig as JaxConfig
from elevation_mapping_cupy_tpu.runtime import native as jnative
from elevation_mapping_cupy_tpu.runtime import service as jservice
from elevation_mapping_cupy_tpu.sensor import create_pcl_from_image as jcreate_pcl
from elevation_mapping_cupy_tpu.sensor import decode_max as jdecode_max
from elevation_mapping_cupy_tpu.sensor import encode_max as jencode_max

from elevation_mapping_cupy_torch import MapConfig, load_config_with_extras
from elevation_mapping_cupy_torch.runtime import native
from elevation_mapping_cupy_torch.runtime import service
from elevation_mapping_cupy_torch.runtime.service import MappingService, SensorFrame
from elevation_mapping_cupy_torch.sensor import create_pcl_from_image, decode_max, encode_max

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(resolution=0.1, map_length=2.0, max_ray_length=0.5, max_points=1024)
ATOL = 1e-4
EYE = np.eye(3, dtype=np.float32)
LAYERS = ["elevation", "variance", "is_valid", "traversability", "upper_bound"]


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def services(**kw):
    """(JAX service, port service on the CPU) of the same config."""
    cfg = kw.pop("cfg", {})
    return (jservice.MappingService(JaxConfig(**{**CFG_KW, **cfg}), **kw),
            MappingService(MapConfig(**{**CFG_KW, **cfg}), device="cpu", **kw))


def frame(pkg, data, channels=("x", "y", "z"), t=(0, 0, 0.5), R=EYE):
    return pkg.SensorFrame(kind="pointcloud", channels=tuple(channels), data=data,
                           R=np.asarray(R, np.float32), t=np.array(t, np.float32))


def assert_layers_close(got: dict, want: dict, packed=()):
    """Layer by layer: equal NaN patterns, values within ATOL on jointly
    finite cells (the names in ``packed`` bit for bit)."""
    assert set(got) == set(want)
    for name in want:
        a, b = np.asarray(got[name], np.float32), np.asarray(want[name], np.float32)
        assert a.shape == b.shape, name
        if name in packed:
            np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=name)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        both = np.isfinite(a) & np.isfinite(b)
        np.testing.assert_allclose(a[both], b[both], rtol=0, atol=ATOL, err_msg=name)


def assert_same_maps(jsvc, tsvc, names=LAYERS, packed=()):
    assert_layers_close(tsvc.mapper.get_layers(names), jsvc.mapper.get_layers(names), packed)


def test_service_end_to_end(rng):
    jsvc, tsvc = services()
    published = ({}, {})
    alive = ([], [])
    for svc, pub, al in zip((jsvc, tsvc), published, alive):
        svc.add_publisher("map", ["elevation", "traversability"], fps=100.0, callback=pub.update)
        svc.on_alive(lambda al=al: al.append(1))
        svc.update_pose(np.array([0.0, 0.0, 0.0]), np.eye(3))
    for _ in range(3):
        pts = rng.uniform(-0.9, 0.9, (800, 3)).astype(np.float32)
        pts[:, 2] = rng.uniform(-0.1, 0.2, 800)
        assert jsvc.enqueue(frame(jservice, pts)) and tsvc.enqueue(frame(service, pts))
    assert jsvc.spin_once(now=100.0) == tsvc.spin_once(now=100.0) == 3
    for svc in (jsvc, tsvc):
        assert svc.stats.frames_processed == 3 and svc.stats.frames_dropped == 0
        assert svc.stats.pointcloud_process_fps > 0
    assert len(alive[0]) == len(alive[1]) == 3
    assert np.isfinite(published[1]["elevation"]).any()
    assert_layers_close(published[1], published[0])
    assert_same_maps(jsvc, tsvc)

    subs = [svc.get_submap(np.zeros(2), (0.6, 0.6), ["elevation"]) for svc in (jsvc, tsvc)]
    assert subs[1]["elevation"].shape[0] <= 8
    assert_layers_close(subs[1], subs[0])

    poly = np.array([[0, 0], [0.5, 0], [0, 0.5]])
    (js, jt, ju), = jsvc.check_safety([poly])
    (ts, tt, tu), = tsvc.check_safety([poly])
    assert js == ts and abs(jt - tt) <= ATOL and ju.shape == tu.shape

    tsvc.clear_map()
    assert float(tsvc.mapper.state.layers[2].sum()) == 0


def test_queue_overflow_drops():
    for pkg, svc in zip((jservice, service), services(queue_size=2)):
        f = frame(pkg, np.zeros((10, 3), np.float32), t=(0, 0, 0))
        assert svc.enqueue(f) and svc.enqueue(f)
        assert not svc.enqueue(f)
        assert svc.stats.frames_dropped == 1


def test_create_pcl_from_image(rng):
    H, W = 24, 32
    depth = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    depth[0, 0] = 0.0
    depth[3, 5] = np.nan
    K = np.array([[30, 0, 16], [0, 30, 12], [0, 0, 1]], np.float32)
    rgb = rng.integers(0, 255, (3, H, W)).astype(np.uint8)
    sem = {"grass": rng.uniform(0, 1, (H, W)).astype(np.float32)}
    conf = rng.uniform(0, 20, (H, W)).astype(np.float32)
    for kw in ({}, {"confidence": conf, "stride": 2}):
        cloud, names = create_pcl_from_image(depth, K, channels=sem, rgb=rgb, **kw)
        jcloud, jnames = jcreate_pcl(depth, K, channels=sem, rgb=rgb, **kw)
        assert names == jnames == ["x", "y", "z", "rgb", "grass"]
        np.testing.assert_array_equal(cloud.view(np.uint32), jcloud.view(np.uint32))
    cloud, _ = create_pcl_from_image(depth, K, channels=sem, rgb=rgb)
    assert cloud.shape == (H * W - 2, 5)
    assert np.allclose(sorted(cloud[:, 2]), sorted(np.delete(depth.reshape(-1), [0, 3 * W + 5])), atol=1e-5)


def test_encode_decode_numpy(rng):
    prob = rng.uniform(0, 1, 50).astype(np.float32)
    cls = rng.integers(0, 100, 50).astype(np.uint32)
    packed = encode_max(prob, cls)
    np.testing.assert_array_equal(packed.view(np.uint32), jencode_max(prob, cls).view(np.uint32))
    p, c = decode_max(packed)
    jp, jc = jdecode_max(packed)
    np.testing.assert_array_equal(c, cls)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_allclose(p, prob.astype(np.float16).astype(np.float32))


def test_semantic_image_node(rng):
    """SemanticImageNode: resize scaling, channel stack, intrinsics, vis,
    equal to the JAX node's."""
    from elevation_mapping_cupy_tpu.sensor.image_node import ImageParameter as JParam
    from elevation_mapping_cupy_tpu.sensor.image_node import SemanticImageNode as JNode

    from elevation_mapping_cupy_torch.sensor.image_node import ImageParameter, SemanticImageNode, voc_color_map

    kw = dict(channels=("f0", "f1"), semantic_model="random_features", resize=0.5)
    node = SemanticImageNode(ImageParameter(**kw), device="cpu")
    jnode = JNode(JParam(**kw))
    img = rng.integers(0, 255, (3, 40, 60), np.uint8)
    K = np.array([[50, 0, 30], [0, 50, 20], [0, 0, 1]], np.float32)
    out, jout = node(img, K), jnode(img, K)
    assert out["image"].shape == (2, 20, 30)
    assert out["channels"] == jout["channels"] == ["sem_f0", "sem_f1"]
    np.testing.assert_array_equal(out["image"], jout["image"])
    np.testing.assert_array_equal(out["label_vis"], jout["label_vis"])
    np.testing.assert_array_equal(out["K"], jout["K"])
    np.testing.assert_allclose(out["K"][0, 0], 25.0)
    assert node.channel_info() == ["sem_f0", "sem_f1"]
    cm = voc_color_map(21)
    assert cm.shape == (21, 3) and cm.dtype == np.uint8
    from elevation_mapping_cupy_tpu.sensor.image_node import voc_color_map as jvoc

    np.testing.assert_array_equal(voc_color_map(64, normalized=True), jvoc(64, normalized=True))


def test_service_aux_services(rng):
    """set_publish_points / map pointcloud export / clear-with-initializer /
    map->odom drift error, against the JAX service."""
    jsvc, tsvc = services(cfg=dict(map_length=4.0, max_ray_length=1.0, max_points=2048))
    pts = rng.uniform(-1.8, 1.8, (2000, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(0.0, 0.2, 2000)
    for pkg, svc in ((jservice, jsvc), (service, tsvc)):
        svc.enqueue(frame(pkg, pts, t=(0, 0, 0.8)))
        svc.spin_once()
        assert svc.get_map_pointcloud().shape == (0, 3)  # disabled by default
        assert svc.set_publish_points(True)
    cloud, jcloud = tsvc.get_map_pointcloud(), jsvc.get_map_pointcloud()
    assert cloud.shape == jcloud.shape and len(cloud) > 100
    np.testing.assert_allclose(cloud, jcloud, rtol=0, atol=ATOL)
    assert 0.5 < float(np.median(cloud[:, 2])) < 1.1

    err = tsvc.map_to_odom_error()
    assert isinstance(err, float) and abs(err - jsvc.map_to_odom_error()) <= ATOL

    for provider, grid in ((np.array([[-1, -1, 0.1], [1, -1, 0.1], [1, 1, 0.1], [-1, 1, 0.1]]), 0.5),
                           (np.array([[0, 0, 0.3]]), 0.8)):
        for svc in (jsvc, tsvc):
            svc.initialize_points_provider = lambda p=provider: p.astype(np.float64)
            svc.clear_map_with_initializer(tf_grid_size=grid)
        elev = tsvc.mapper.get_layers(["elevation"])["elevation"]
        assert np.isfinite(elev[10:-10, 10:-10]).sum() > 0
        assert_same_maps(jsvc, tsvc, ["elevation", "is_valid", "upper_bound"])

    # exactly 3 provider points on a cleared map: griddata cannot run, the
    # request is dropped and counted (ValueError in the port, AssertionError in JAX)
    for svc in (jsvc, tsvc):
        svc.initialize_points_provider = lambda: np.array([[0, 0, 0.1], [1, 0, 0.1], [0, 1, 0.1]])
        svc.clear_map_with_initializer()
    assert tsvc.stats.frames_dropped == jsvc.stats.frames_dropped == 1


@pytest.mark.parametrize("plain", [False, True])
def test_native_frame_ring(rng, plain):
    """The ring (native and its plain version): bounded memory, drop
    policies, stats, the same behaviour as the JAX package's native ring."""
    jring = jnative.FrameRing(capacity=3, slab_bytes=4096, header_bytes=16)
    ring = native.FrameRing(capacity=3, slab_bytes=4096, header_bytes=16, plain=plain)
    payloads = [rng.standard_normal(i + 4).astype(np.float32) for i in range(5)]
    results = [ring.push(f"h{i}".encode(), p) for i, p in enumerate(payloads)]
    assert results == [jring.push(f"h{i}".encode(), p) for i, p in enumerate(payloads)]
    assert results == [True, True, True, False, False]  # drop-newest
    assert len(ring) == len(jring) == 3
    (h, p), (jh, jp) = ring.pop(), jring.pop()
    assert h == jh and h[:2] == b"h0" and len(h) == 16
    np.testing.assert_array_equal(p.view(np.float32), payloads[0])
    np.testing.assert_array_equal(p, jp)
    assert ring.stats() == {"pushed": 3, "popped": 1, "dropped": 2}
    assert ring.stats()["dropped"] == jring.stats()["dropped"]

    old = native.FrameRing(capacity=2, slab_bytes=64, header_bytes=8, drop_oldest=True, plain=plain)
    for i in range(4):
        assert old.push(bytes([65 + i]), np.int32([i]))
    h, p = old.pop()
    assert p.view(np.int32)[0] == 2 and h[:1] == b"C"  # two oldest were overwritten
    assert old.pop()[1].view(np.int32)[0] == 3 and old.pop() is None
    assert old.stats() == {"pushed": 4, "popped": 2, "dropped": 2}

    with pytest.raises(ValueError):  # bounded memory is a contract
        ring.push(b"x", np.zeros(4097, np.uint8))


@pytest.mark.parametrize("plain", [False, True])
def test_frame_ring_under_many_producers(plain):
    """More producer threads than cores push numbered frames into a small
    ring while one consumer pops, with a short switch interval: every frame
    is either popped whole exactly once or counted as dropped."""
    import sys

    ring = native.FrameRing(capacity=4, slab_bytes=64, header_bytes=8, drop_oldest=True, plain=plain)
    n_threads, per_thread = 2 * (os.cpu_count() or 4), 200
    popped, done = [], threading.Event()

    def produce(k):
        for i in range(per_thread):
            ring.push(b"f", np.full(4, k * per_thread + i, np.int32))

    def consume():
        while not done.is_set() or len(ring):
            item = ring.pop()
            if item is not None:
                popped.append(item[1].view(np.int32))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        consumer = threading.Thread(target=consume)
        consumer.start()
        producers = [threading.Thread(target=produce, args=(k,)) for k in range(n_threads)]
        for th in producers:
            th.start()
        for th in producers:
            th.join(timeout=60)
        done.set()
        consumer.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not consumer.is_alive() and not any(th.is_alive() for th in producers)
    ids = [int(p[0]) for p in popped]
    assert all((p == p[0]).all() for p in popped), "a frame was torn"
    assert len(set(ids)) == len(ids), "a frame was popped twice"
    stats = ring.stats()
    assert stats["pushed"] == n_threads * per_thread and stats["popped"] == len(ids)
    assert stats["popped"] + stats["dropped"] == stats["pushed"]


def test_native_deinterleave_and_pack_rgb_bit_for_bit(rng):
    """Native = plain = the JAX package's native code, bit for bit: NaN and
    inf rows dropped (or kept), a field past the x/y/z ones, odd offsets."""
    n = 3001
    rec = rng.standard_normal((n, 6)).astype(np.float32)
    rec[rng.integers(0, n, 40), rng.integers(0, 3, 40)] = np.nan
    rec[7, 2] = np.inf
    rec[9, 3] = np.nan  # a NaN outside x/y/z stays
    raw = rec.tobytes()
    n_finite = int(np.isfinite(rec[:, :3]).all(axis=1).sum())
    assert n_finite < n - 20
    for offsets, drop in (([0, 4, 8, 16], True), ([0, 4, 8], False), ([8, 4, 0, 20, 12], True)):
        got = native.deinterleave(raw, n, 24, offsets, drop)
        plain = native.deinterleave(raw, n, 24, offsets, drop, plain=True)
        want = jnative.deinterleave(raw, n, 24, offsets, drop)
        assert got.shape == want.shape == (n_finite if drop else n, len(offsets))
        np.testing.assert_array_equal(got.view(np.uint32), plain.view(np.uint32))
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # the last record must hold its last field; what follows it may be cut
    assert native.deinterleave(raw[: (n - 1) * 24 + 12], n, 24, [0, 4, 8], False).shape == (n, 3)
    for plain in (False, True):
        with pytest.raises(ValueError):
            native.deinterleave(raw[: (n - 1) * 24 + 11], n, 24, [0, 4, 8], plain=plain)

    r, g, b = (rng.integers(0, 256, 1000).astype(np.uint8) for _ in range(3))
    got = native.pack_rgb(r, g, b)
    np.testing.assert_array_equal(got.view(np.uint32), native.pack_rgb(r, g, b, plain=True).view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), jnative.pack_rgb(r, g, b).view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), torch_scenes.pack_rgb(np.stack([r, g, b], 1)).view(np.uint32))


@pytest.mark.parametrize("compiler", ["/nonexistent/bin/g++", "false"])
def test_failed_native_build_raises(monkeypatch, compiler):
    """A compiler that is missing or fails raises NativeBuildError with what
    it said; no call falls back to the plain version."""
    monkeypatch.setattr(native, "CXX", compiler)
    assert not os.path.exists(native.library_path())
    with pytest.raises(native.NativeBuildError, match="cannot run the compiler" if "/" in compiler else "failed"):
        native.load()
    with pytest.raises(native.NativeBuildError):
        native.deinterleave(np.zeros(12, np.float32).tobytes(), 1, 12, [0, 4, 8])
    with pytest.raises(native.NativeBuildError):
        native.FrameRing()
    assert not os.path.exists(native.library_path())


def test_library_is_built_under_build_not_beside_the_source():
    lib = native.load()
    path = native.library_path()
    assert lib is native.load() and os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "build", "elevation_mapping_cupy_torch")
    assert not [f for f in os.listdir(os.path.dirname(native.__file__)) if f.endswith(".so")]


def _raw_cloud(rng, n_pts=700):
    pts = rng.uniform(-0.9, 0.9, (n_pts, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-0.1, 0.2, n_pts).astype(np.float32)
    intensity = rng.uniform(0, 1, n_pts).astype(np.float32)
    rec = np.zeros((n_pts, 5), np.float32)
    rec[:, :3] = pts
    rec[:, 4] = intensity
    bad = np.array([3, 77, 500])
    rec[bad, 1] = np.nan
    keep = np.ones(n_pts, bool)
    keep[bad] = False
    return rec.tobytes(), np.concatenate([pts[keep], intensity[keep, None]], axis=1)


def test_raw_ingest_end_to_end(rng):
    """Raw interleaved bytes -> native ring -> native deinterleave -> map
    update: equal to the direct SensorFrame path and to the JAX service's
    raw path."""
    n_pts = 700
    raw, mat = _raw_cloud(rng, n_pts)
    args = (raw, n_pts, 20, [0, 4, 8, 16], ["x", "y", "z", "intensity"], EYE, np.array([0, 0, 0.5], np.float32))
    jsvc, tsvc = services(cfg=dict(enable_visibility_cleanup=False))
    for svc in (jsvc, tsvc):
        svc.enable_raw_ingest(capacity=4, slab_bytes=1 << 20)
        assert svc.enqueue_raw_pointcloud(*args, stamp=1.5)
        assert svc.spin_once(now=1.0) == 1 and svc.stats.frames_processed == 1
    direct = MappingService(MapConfig(**CFG_KW, enable_visibility_cleanup=False), device="cpu")
    direct.enqueue(frame(service, mat, ("x", "y", "z", "intensity")))
    direct.spin_once(now=1.0)
    a = tsvc.mapper.get_layers(LAYERS)
    np.testing.assert_array_equal(np.nan_to_num(a["elevation"]),
                                  np.nan_to_num(direct.mapper.get_layers(["elevation"])["elevation"]))
    assert_same_maps(jsvc, tsvc)

    # backpressure: a full ring drops (queue_size semantics) and counts it
    for svc in services():
        svc.enable_raw_ingest(capacity=2, slab_bytes=1 << 20)
        assert [svc.enqueue_raw_pointcloud(*args) for _ in range(4)] == [True, True, False, False]
        assert svc.stats.frames_dropped == 2

    # subscriber wiring: channels fall back to the configured list
    svc3 = MappingService(MapConfig(**CFG_KW, enable_visibility_cleanup=False), device="cpu")
    svc3.subscribers = service.parse_subscribers({"front_lidar": {"data_type": "pointcloud", "topic_name": "/pc"}})
    svc3.enable_raw_ingest()
    assert svc3.enqueue_raw_pointcloud(raw, n_pts, 20, [0, 4, 8], [], EYE, args[-1], subscriber="front_lidar")
    assert svc3.spin_once(now=1.0) == 1
    assert not svc3.enqueue_raw_pointcloud(raw, n_pts, 20, [0, 4, 8], [], EYE, args[-1], subscriber="nope")
    with pytest.raises(RuntimeError, match="enable_raw_ingest"):
        MappingService(MapConfig(**CFG_KW), device="cpu").enqueue_raw_pointcloud(*args)


def test_producer_threads_push_while_the_consumer_spins(rng):
    """Two producer threads push raw frames while the main thread spins:
    every frame is mapped once, on the spinning thread, and the map equals
    the same frames pushed and drained in order on one thread."""
    clouds = [_raw_cloud(np.random.default_rng(i), 600)[0] for i in range(8)]
    cfg = MapConfig(**CFG_KW, enable_visibility_cleanup=False)
    svc = MappingService(cfg, device="cpu")
    svc.enable_raw_ingest(capacity=16, slab_bytes=1 << 16)
    spin_threads = set()
    svc.on_alive(lambda: spin_threads.add(threading.get_ident()))
    t = np.array([0, 0, 0.5], np.float32)

    def produce(part):
        for c in part:
            assert svc.enqueue_raw_pointcloud(c, 600, 20, [0, 4, 8], ["x", "y", "z"], EYE, t)

    threads = [threading.Thread(target=produce, args=(clouds[i::2],)) for i in range(2)]
    for th in threads:
        th.start()
    done = 0
    while any(th.is_alive() for th in threads) or done < len(clouds):
        done += svc.spin_once(now=0.0)
    for th in threads:
        th.join()
    assert done == len(clouds) and svc.stats.frames_processed == len(clouds)
    assert spin_threads == {threading.get_ident()}
    assert svc._ring.stats() == {"pushed": 8, "popped": 8, "dropped": 0}
    # the threads interleave in any order; the set of cells a frame makes
    # valid does not depend on it
    seq = MappingService(cfg, device="cpu")
    for c in clouds:
        seq.enqueue(SensorFrame.from_pointcloud2(c, 600, 20, [0, 4, 8], ["x", "y", "z"], EYE, t))
    seq.spin_once(now=0.0)
    a, b = svc.mapper.get_layers(["is_valid"]), seq.mapper.get_layers(["is_valid"])
    np.testing.assert_array_equal(a["is_valid"], b["is_valid"])


def _bump_cloud(rng):
    pts = rng.uniform(-0.9, 0.9, (900, 3)).astype(np.float32)
    pts[:, 2] = -0.8
    bump = (np.abs(pts[:, 0] - 0.5) < 0.15) & (np.abs(pts[:, 1] - 0.5) < 0.15)
    pts[bump, 2] = -0.4
    return pts


def test_get_submap_asymmetric_region(rng):
    """get_submap returns the terrain at the queried world position, not its
    mirror image, and the same window as the JAX service."""
    jsvc, tsvc = services(cfg=dict(enable_visibility_cleanup=False))
    pts = _bump_cloud(rng)
    for pkg, svc in ((jservice, jsvc), (service, tsvc)):
        svc.enqueue(frame(pkg, pts, t=(0, 0, 0.8)))
        svc.spin_once()
    for c in ((0.5, 0.5), (-0.5, -0.5), (0.3, -0.2)):
        got = tsvc.get_submap(np.array(c), (0.3, 0.3), ["elevation", "is_valid"])
        assert_layers_close(got, jsvc.get_submap(np.array(c), (0.3, 0.3), ["elevation", "is_valid"]))
    hi = tsvc.get_submap(np.array([0.5, 0.5]), (0.3, 0.3), ["elevation"])["elevation"]
    lo = tsvc.get_submap(np.array([-0.5, -0.5]), (0.3, 0.3), ["elevation"])["elevation"]
    assert np.nanmax(hi) > 0.3, "bump missing at its true world position"
    assert np.nanmax(np.where(np.isfinite(lo), lo, 0)) < 0.2, "bump mirrored"


def _step_services(rng, n, step):
    jsvc, tsvc = services()
    pts = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    pts[:, 2] = step(pts[:, 0]).astype(np.float32)
    for pkg, svc in ((jservice, jsvc), (service, tsvc)):
        svc.enqueue(frame(pkg, pts))
        svc.spin_once(now=1.0)
    return jsvc, tsvc


def test_get_submap_identity_transform_matches(rng):
    jsvc, tsvc = _step_services(rng, 900, lambda x: 0.1 * np.sign(x))
    plain = tsvc.get_submap(np.zeros(2), (1.0, 1.0), ["elevation"])["elevation"]
    ident = tsvc.get_submap(np.zeros(2), (1.0, 1.0), ["elevation"], frame_transform=(np.eye(3), np.zeros(3)))
    assert ident["elevation"].shape == plain.shape
    both = np.isfinite(plain) & np.isfinite(ident["elevation"])
    assert both.sum() > 10
    np.testing.assert_allclose(ident["elevation"][both], plain[both], atol=1e-5)
    assert_layers_close(ident, jsvc.get_submap(np.zeros(2), (1.0, 1.0), ["elevation"],
                                               frame_transform=(np.eye(3), np.zeros(3))))


def test_get_submap_rotated_frame(rng):
    """90-deg-yaw request frame lifted by 1 m: the x-step appears as a
    y-step, heights shift, and the grid equals the JAX service's."""
    jsvc, tsvc = _step_services(rng, 4000, lambda x: np.where(x > 0, 0.2, 0.0))
    Rf = np.array([[0.0, -1.0, 0], [1.0, 0.0, 0], [0, 0, 1]], np.float64)
    tf = np.array([0.0, 0.0, 1.0])
    got = tsvc.get_submap(np.zeros(2), (1.2, 1.2), ["elevation", "variance"], frame_transform=(Rf, tf))
    want = jsvc.get_submap(np.zeros(2), (1.2, 1.2), ["elevation", "variance"], frame_transform=(Rf, tf))
    assert_layers_close(got, want)
    sub = got["elevation"]
    assert np.isfinite(sub).sum() > 50
    ny = sub.shape[1]
    assert np.nanmean(sub[:, : ny // 3]) > np.nanmean(sub[:, -ny // 3:]) + 0.1
    assert 1.4 < np.nanmin(sub) < np.nanmax(sub) < 1.75


def test_submap_pitched_transform_drops_out_of_range():
    """A pitched request frame carries tall cells beyond the z=0 corner
    bounds: they are dropped, not clamped onto the border, as in JAX."""
    res, n = 0.1, 11
    xs = ys = (np.arange(n) - n // 2) * res
    h = np.zeros((n, n), np.float32)
    h[0, :] = 5.0
    th = np.deg2rad(30.0)
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]], np.float64)
    layers = {"elevation": h, "grass": np.arange(n * n, dtype=np.float32).reshape(n, n)}
    out = service._transform_submap(layers, xs, ys, "elevation", R, np.zeros(3), res)
    want = jservice._transform_submap(layers, xs, ys, "elevation", R, np.zeros(3), res)
    for name in layers:
        np.testing.assert_array_equal(out[name], want[name])
    finite = out["elevation"][np.isfinite(out["elevation"])]
    assert finite.size > 0 and np.nanmax(finite) < 1.0


def test_pointcloud_sensor_node(rng):
    """Sidecar node: depth+rgb frame -> semantic cloud -> mapping service,
    the cloud and the fused layers equal to the JAX package's."""
    from elevation_mapping_cupy_tpu.sensor.pointcloud import PointcloudParameter as JParam
    from elevation_mapping_cupy_tpu.sensor.pointcloud import PointcloudSensorNode as JNode

    from elevation_mapping_cupy_torch.sensor.pointcloud import PointcloudParameter, PointcloudSensorNode

    H, W = 24, 32
    node = PointcloudSensorNode(PointcloudParameter(channels=("feat_0", "feat_1")),
                                semantic_model="random_features", device="cpu")
    jnode = JNode(JParam(channels=("feat_0", "feat_1")), semantic_model="random_features")
    depth = rng.uniform(0.6, 1.3, (H, W)).astype(np.float32)
    rgb = rng.integers(0, 255, (3, H, W)).astype(np.uint8)
    K = np.array([[30, 0, 16], [0, 30, 12], [0, 0, 1]], np.float32)
    cloud, names = node(depth, K, rgb=rgb)
    jcloud, jnames = jnode(depth, K, rgb=rgb)
    assert names == jnames == ["x", "y", "z", "rgb", "feat_0", "feat_1"]
    assert cloud.shape == (H * W, 6)
    np.testing.assert_array_equal(cloud.view(np.uint32), jcloud.view(np.uint32))

    sem = dict(pointcloud_channel_fusions=(("rgb", "color"), ("default", "average")),
               semantic_layers=("rgb", "feat_0", "feat_1"))
    jsvc, tsvc = services(cfg=sem)
    R_cam = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    for pkg, svc in ((jservice, jsvc), (service, tsvc)):
        assert svc.enqueue(frame(pkg, cloud, names, t=(0, 0, 1.0), R=R_cam)) and svc.spin_once() == 1
    assert np.abs(tsvc.mapper.get_layers(["feat_0"])["feat_0"]).sum() > 0
    assert_same_maps(jsvc, tsvc, LAYERS + ["feat_0", "feat_1", "rgb"], packed=("rgb",))


TWO_SENSOR_YAML = """
resolution: 0.1
map_length: 2.0
max_ray_length: 0.5
max_points: 1024
semantic_layers: [grass, rgb]
pointcloud_channel_fusions:
  default: class_average
image_channel_fusions:
  rgb: color
  default: exponential
update_variance_fps: 2.0
time_interval: 0.5
subscribers:
  front_lidar:
    topic_name: /lidar/points
    data_type: pointcloud
    channels: [grass]
  color_cam:
    topic_name: /camera/rgb/image_raw
    camera_info_topic_name: /camera/depth/camera_info
    data_type: image
publishers:
  elevation_map_raw:
    layers: [elevation, rgb, grass]
    basic_layers: [elevation]
    fps: 100.0
"""


def test_config_driven_two_sensor_setup(tmp_path, rng):
    """subscribers: YAML block wires a pointcloud with a semantic channel and
    an rgb image with distinct fusions; both services publish the same."""
    path = tmp_path / "setup.yaml"
    path.write_text(TWO_SENSOR_YAML)
    jsvc = jservice.MappingService.from_config(str(path))
    tsvc = MappingService.from_config(str(path), device="cpu")
    assert set(tsvc.subscribers) == {"front_lidar", "color_cam"}
    assert tsvc.subscribers == {k: service.SubscriberConfig(**vars(v)) for k, v in jsvc.subscribers.items()}
    assert tsvc.subscribers["front_lidar"].channels == ("x", "y", "z", "grass")
    assert tsvc._variance_period == jsvc._variance_period == 0.5 and tsvc._time_period == 0.5
    assert [p.basic_layers for p in tsvc.publishers] == [("elevation",)]

    pts = rng.uniform(-0.9, 0.9, (800, 4)).astype(np.float32)
    pts[:, 2] = rng.uniform(-0.05, 0.05, 800)
    pts[:, 3] = 0.8
    H, W = 24, 24
    img = np.zeros((3, H, W), np.float32)
    img[1] = 200.0
    K = np.array([[20, 0, W / 2], [0, 20, H / 2], [0, 0, 1]], np.float32)
    published = ({}, {})
    for pkg, svc, pub in ((jservice, jsvc, published[0]), (service, tsvc, published[1])):
        assert svc.enqueue(frame(pkg, pts, ()), subscriber="front_lidar")
        im = pkg.SensorFrame(kind="image", channels=(), data=img, R=EYE, t=np.array([0, 0, 1.0], np.float32),
                             K=K, D=np.zeros(5, np.float32))
        assert svc.enqueue(im, subscriber="color_cam")
        assert not svc.enqueue(im, subscriber="front_lidar")
        assert svc.stats.frames_dropped == 1
        assert svc.spin_once(now=1.0) == 2
        svc.set_publisher_callback("elevation_map_raw", pub.update)
        svc.spin_once(now=2.0)
    assert set(published[1]) == {"elevation", "rgb", "grass"}
    assert np.nanmax(published[1]["grass"]) > 0.3
    assert_layers_close(published[1], published[0], packed=("rgb",))


def test_chip_smoke_service_settings_are_the_yaml():
    """The card tests' service runs on the deployed config and its extras as
    literals (the card's machine has no PyYAML): they equal the YAML's, and
    a service built from them is built as from_config builds it."""
    cfg, extras = load_config_with_extras(os.path.join(REPO, "configs", "core_param.yaml"))
    assert cfg == torch_scenes.deployed_config()
    assert extras == torch_scenes.DEPLOYED_EXTRAS
    a = MappingService.from_config(os.path.join(REPO, "configs", "core_param.yaml"), device="cpu")
    b = MappingService.from_settings(torch_scenes.deployed_config(), torch_scenes.DEPLOYED_EXTRAS, device="cpu")
    for attr in ("_variance_period", "_time_period", "_pose_alpha", "publish_points_enabled", "subscribers"):
        assert getattr(a, attr) == getattr(b, attr), attr
    assert a._pose_alpha == 0.2 and a._time_period == pytest.approx(0.1)


def test_default_device_is_cuda():
    """No device means CUDA; without a card the service and the sidecar nodes
    raise and name the way out."""
    from elevation_mapping_cupy_torch.sensor.image_node import ImageParameter, SemanticImageNode
    from elevation_mapping_cupy_torch.sensor.pointcloud import PointcloudSensorNode

    if torch.cuda.is_available():
        assert MappingService(MapConfig(**CFG_KW)).mapper.state.layers.device.type == "cuda"
        return
    for make in (lambda: MappingService(MapConfig(**CFG_KW)),
                 lambda: PointcloudSensorNode(),
                 lambda: SemanticImageNode(ImageParameter(semantic_model="random_features"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert MappingService(MapConfig(**CFG_KW), device="cpu").mapper.state.layers.device.type == "cpu"
