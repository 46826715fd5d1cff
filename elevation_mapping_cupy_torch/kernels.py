"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes plain C entry points. It is compiled with
``nvcc`` for ``sm_90a`` (Hopper) into a shared library under
``build/elevation_mapping_cupy_torch/`` beside the package, at first use on a
CUDA tensor, and loaded with ``ctypes``. The library's file name carries a
hash of its source, so an edited source is rebuilt and a stale library is
never loaded. Importing this module needs no ``nvcc`` and no card.

A failed build or a failed launch raises; there is no fallback. Every
wrapper of a kernel dispatches through :func:`on_card`: the kernel for a CUDA
tensor, its plain PyTorch version for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, List, Sequence

import torch

__all__ = [
    "CudaKernel", "KernelError", "nvcc_path", "build_all", "on_card", "registered_kernels", "CSRC_DIR", "BUILD_DIR",
]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "elevation_mapping_cupy_torch")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_BUILD_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels cannot be built")
    return path


def _library_path(source: str) -> str:
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def _start_build(source: str):
    """Start nvcc for one source; returns (process, temporary output, final
    library path, command), or None when the library is already built."""
    lib = _library_path(source)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib, cmd


def _finish_build(started) -> None:
    if started is None:
        return
    proc, tmp, lib, cmd = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    # rename is atomic: a concurrent build of the same source loads either
    # its own library or this one, never a half-written file
    os.replace(tmp, lib)


def build_all(sources: Iterable[str]) -> List[str]:
    """Build several sources at once, one nvcc process each, all started
    together. Returns the library paths."""
    sources = list(sources)
    with _BUILD_LOCK:
        started = [_start_build(s) for s in sources]
        errors = []
        for s in started:
            try:
                _finish_build(s)
            except KernelError as e:
                errors.append(str(e))
        if errors:
            raise KernelError("\n".join(errors))
    return [_library_path(s) for s in sources]


class CudaKernel:
    """One C entry point of one ``csrc`` source.

    ``launches`` counts the launches made through :meth:`launch` and
    nothing else; a run resets it to 0 and reads it to show that a path went
    through this kernel.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence, name: str = None):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.name = name or symbol
        self.launches = 0
        self._fn = None

    def load(self):
        """Build (if needed) and bind the entry point."""
        if self._fn is None:
            lib_path = build_all([self.source])[0]
            fn = getattr(ctypes.CDLL(lib_path), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """One launch on ``device``'s current stream, which the entry point
        takes as its last argument after ``args``. A device that is not a
        card is refused before the kernel is built."""
        if device.type != "cuda":
            raise ValueError(f"the {self.name} kernel runs on cuda tensors, not {device}")
        fn = self.load()
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise KernelError(f"{self.name}: launch failed with CUDA error {rc}")
        self.launches += 1


def on_card(x: torch.Tensor, what: str) -> bool:
    """Whether ``what`` runs its kernel (``x`` on a card) or its plain
    version (``x`` on the CPU); any other device is refused."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what} runs on cuda or cpu tensors, not {x.device}")


def registered_kernels() -> Dict[str, CudaKernel]:
    """Every kernel of the package, by name (imports the modules that own them)."""
    from .ops import cuda_march, cuda_scatter, point_stages, raycast, stencil

    return {k.name: k for k in (cuda_scatter.KERNEL, cuda_march.KERNEL, stencil.KERNEL, raycast.KERNEL,
                                raycast.SCAN_KERNEL, point_stages.ASSOCIATE_KERNEL, point_stages.FUSE_KERNEL)}
