"""ctypes bindings for the native sensor frontend: the PointCloud2-style
deinterleave, the rgb packing and the bounded frame ring.

``pointcloud_native.cc`` and ``frame_ring.cc`` are built with ``g++ -O3
-shared -fPIC`` into one shared library under
``build/elevation_mapping_cupy_torch/`` beside the package, at first use.
The library's file name carries a hash of both sources and of the compiler
command, so an edited source is rebuilt and a stale library is never
loaded. The build writes a temporary file and renames it into place:
processes that build at once each load a whole library, never a
half-written one. A failed build raises :class:`NativeBuildError` with the
compiler's output; nothing falls back.

Each function has a plain NumPy version beside it (``plain=True``), which
the tests hold the library to. Nothing selects it but that argument.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Dict, Sequence

import numpy as np

from ...kernels import BUILD_DIR

__all__ = ["NativeBuildError", "CXX", "library_path", "load", "deinterleave", "pack_rgb", "FrameRing"]

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("pointcloud_native.cc", "frame_ring.cc")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    """The native library failed to build or to load."""


def _command(out: str):
    return [CXX, *CXX_FLAGS, "-o", out, *(os.path.join(_DIR, s) for s in SOURCES)]


def library_path() -> str:
    h = hashlib.sha1(" ".join(_command("")).encode())
    for s in SOURCES:
        with open(os.path.join(_DIR, s), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpointcloud_native-{h.hexdigest()[:12]}.so")


def _build(lib: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = _command(tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise NativeBuildError(f"cannot run the compiler: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeBuildError(f"{CXX} failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, lib)


def load() -> ctypes.CDLL:
    """Build (if needed) and bind the library."""
    lib_path = library_path()
    with _LOCK:
        if lib_path in _LIBS:
            return _LIBS[lib_path]
        if not os.path.exists(lib_path):
            _build(lib_path)
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError as e:
            raise NativeBuildError(f"cannot load {lib_path}: {e}") from e
        lib.deinterleave_f32.restype = ctypes.c_int64
        lib.deinterleave_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.pack_rgb_f32.restype = None
        lib.pack_rgb_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_push.restype = ctypes.c_int32
        lib.ring_push.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32,
        ]
        lib.ring_pop.restype = ctypes.c_int64
        lib.ring_pop.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.ring_size.restype = ctypes.c_int64
        lib.ring_size.argtypes = [ctypes.c_void_p]
        lib.ring_stats.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
        _LIBS[lib_path] = lib
        return lib


def _bytes(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, np.uint8)
    return np.ascontiguousarray(data).view(np.uint8).reshape(-1)


def deinterleave(
    data,
    n_points: int,
    point_step: int,
    offsets: Sequence[int],
    drop_non_finite: bool = True,
    plain: bool = False,
) -> np.ndarray:
    """Interleaved sensor records -> dense (kept, n_fields) float32 matrix:
    a float32 at each byte offset of each ``point_step``-byte record, rows
    with a non-finite x, y or z dropped when ``drop_non_finite``."""
    buf = _bytes(data)
    n_fields = len(offsets)
    if n_points and buf.shape[0] < (n_points - 1) * point_step + max(offsets, default=0) + 4:
        raise ValueError(f"{buf.shape[0]} bytes hold fewer than {n_points} records of {point_step} bytes")
    if plain:
        cols = [
            np.lib.stride_tricks.as_strided(buf[off:], shape=(n_points, 4), strides=(point_step, 1))
            .copy().view(np.float32)[:, 0]
            for off in offsets
        ]
        out = np.stack(cols, axis=1) if cols else np.zeros((n_points, 0), np.float32)
        if drop_non_finite:
            out = out[np.isfinite(out[:, :3]).all(axis=1)]
        return out
    out = np.empty((n_points, n_fields), np.float32)
    offs = np.asarray(offsets, np.int64)
    kept = load().deinterleave_f32(
        buf.ctypes.data, n_points, point_step, offs.ctypes.data, n_fields, out.ctypes.data,
        1 if drop_non_finite else 0,
    )
    return out[:kept]


def pack_rgb(r: np.ndarray, g: np.ndarray, b: np.ndarray, plain: bool = False) -> np.ndarray:
    """uint8 planes -> float32 whose bits are 0x00RRGGBB."""
    r = np.ascontiguousarray(r, np.uint8).reshape(-1)
    g = np.ascontiguousarray(g, np.uint8).reshape(-1)
    b = np.ascontiguousarray(b, np.uint8).reshape(-1)
    if plain:
        bits = (r.astype(np.uint32) << 16) | (g.astype(np.uint32) << 8) | b.astype(np.uint32)
        return bits.view(np.float32)
    out = np.empty(r.shape[0], np.float32)
    load().pack_rgb_f32(r.ctypes.data, g.ctypes.data, b.ctypes.data, r.shape[0], out.ctypes.data)
    return out


class FrameRing:
    """Preallocated bounded frame ring (``frame_ring.cc``).

    Frames are (header: bytes of fixed size, payload: ndarray). Memory is one
    slab allocation, capacity x slab_bytes: no per-frame heap churn, bounded
    backpressure with drop-oldest (ROS queue_size semantics) or drop-newest.
    Safe for many producer threads and one consumer. ``plain=True`` gives the
    same ring on a deque, for tests.
    """

    def __init__(self, capacity: int = 16, slab_bytes: int = 8 << 20,
                 header_bytes: int = 256, drop_oldest: bool = False, plain: bool = False):
        self.capacity = capacity
        self.slab_bytes = slab_bytes
        self.header_bytes = header_bytes
        self.drop_oldest = drop_oldest
        self._lib = None
        self._ring = None
        if plain:
            self._dq = collections.deque()
            self._counts = {"pushed": 0, "popped": 0, "dropped": 0}
            self._plain_lock = threading.Lock()
            return
        self._lib = load()
        self._ring = self._lib.ring_create(capacity, slab_bytes, header_bytes)
        if not self._ring:
            raise MemoryError(f"frame ring of {capacity} x {slab_bytes} bytes could not be allocated")
        self._scratch = np.empty(slab_bytes, np.uint8)

    def push(self, header: bytes, payload: np.ndarray) -> bool:
        """Returns False when the frame was rejected (full, drop_oldest off)."""
        h = header[: self.header_bytes].ljust(self.header_bytes, b"\0")
        p = _bytes(payload)
        if p.shape[0] > self.slab_bytes:
            raise ValueError(f"payload {p.shape[0]}B > slab {self.slab_bytes}B")
        if self._ring is not None:
            rc = self._lib.ring_push(self._ring, h, p.ctypes.data, p.shape[0], 1 if self.drop_oldest else 0)
            return rc >= 0
        with self._plain_lock:
            if len(self._dq) >= self.capacity:
                self._counts["dropped"] += 1
                if not self.drop_oldest:
                    return False
                self._dq.popleft()
            self._dq.append((h, p.copy()))
            self._counts["pushed"] += 1
            return True

    def pop(self):
        """Returns (header bytes, payload uint8 ndarray) or None when empty.

        The payload is a copy sized to the frame; the slab-sized staging
        buffer is reused across pops."""
        if self._ring is not None:
            hdr = ctypes.create_string_buffer(self.header_bytes)
            n = self._lib.ring_pop(self._ring, hdr, self._scratch.ctypes.data, self.slab_bytes)
            if n < 0:
                return None
            return bytes(hdr.raw), self._scratch[:n].copy()
        with self._plain_lock:
            if not self._dq:
                return None
            self._counts["popped"] += 1
            return self._dq.popleft()

    def __len__(self) -> int:
        if self._ring is not None:
            return int(self._lib.ring_size(self._ring))
        return len(self._dq)

    def stats(self) -> Dict[str, int]:
        if self._ring is None:
            with self._plain_lock:
                return dict(self._counts)
        pushed, popped, dropped = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        self._lib.ring_stats(self._ring, ctypes.byref(pushed), ctypes.byref(popped), ctypes.byref(dropped))
        return {"pushed": pushed.value, "popped": popped.value, "dropped": dropped.value}

    def __del__(self):
        ring, self._ring = getattr(self, "_ring", None), None
        if ring is not None and self._lib is not None:
            self._lib.ring_destroy(ring)

