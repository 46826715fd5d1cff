"""The polar evaluation's dispatch and the kernel's argument checks, on the CPU.

The kernel itself (``csrc/polar_evaluate.cu``) runs only on a card
(``tests/test_torch_cuda.py``); these tests need neither a card nor
``nvcc``. The plain version is held to the JAX package in
``tests/test_torch_ops.py`` and ``tests/test_torch_parallel.py``.
"""

import math
import os
import re

import pytest
import torch

from elevation_mapping_cupy_torch import MapConfig, kernels
from elevation_mapping_cupy_torch.ops import raycast
from elevation_mapping_cupy_torch.ops.geometry import Block

CFG = MapConfig(resolution=0.1, map_length=2.0, max_ray_length=1.0, raycast_elevation_bins=12,
                raycast_azimuth_bins=16, max_points=256)
LEVELS = 3


def _inputs(b=2, pyramid=False, block=None, seed=0):
    """Arguments of ``polar_evaluate`` for ``b`` maps of CFG: random layers,
    normals and counts, and a prefix cube (and pyramid) of the right shapes."""
    g = torch.Generator().manual_seed(seed)
    n = CFG.cell_n
    block = Block.whole(n, n) if block is None else block
    A, S, R = CFG.azimuth_bins, CFG.raycast_elevation_bins, CFG.n_ray_steps + 2
    layers = torch.rand((b, 7, block.h, block.w), generator=g)
    normal = torch.rand((b, 3, block.h, block.w), generator=g)
    inlier = torch.rand((b, 2, block.h, block.w), generator=g)[:, 0] * 40
    t = torch.rand((b, 3), generator=g) * 0.2
    pref = torch.cumsum(torch.rand((b, A, R, 2 * S), generator=g) * 2, dim=1)
    pyr = torch.rand((b, (LEVELS + 1) * A * R, S), generator=g) if pyramid else None
    return (layers, normal, inlier, t, pref.reshape(b, A * R, 2 * S), pref[:, -1], pyr,
            (A, R, S, LEVELS, block), CFG)


def _bad_arguments(kind):
    """(arguments of launch_polar_evaluate, the error it must raise)."""
    args = list(_inputs(pyramid=kind.startswith("pyramid")))
    if kind == "float64":
        args[0] = args[0].double()
        return args, TypeError
    if kind == "float64_cube":
        args[4] = args[4].double()
        return args, TypeError
    if kind == "strided_cube":
        args[4] = args[4].transpose(0, 1).contiguous().transpose(0, 1)
        return args, ValueError
    if kind == "strided_layers":
        args[0] = args[0].transpose(-1, -2).contiguous().transpose(-1, -2)
        return args, ValueError
    if kind == "strided_counts":
        args[2] = args[2].transpose(-1, -2)
        return args, ValueError
    if kind == "layers_shape":
        args[0] = args[0][:, :6]
        return args, ValueError
    if kind == "normal_shape":
        args[1] = args[1][:1]
        return args, ValueError
    if kind == "total_shape":
        args[5] = args[5][:, 1:]
        return args, ValueError
    if kind == "t_shape":
        args[3] = args[3][:, :2]
        return args, ValueError
    if kind == "pyramid_shape":
        args[6] = args[6][:, 1:]
        return args, ValueError
    if kind == "block_outside":
        n = CFG.cell_n
        args[7] = args[7][:4] + (Block(2, 0, n, n, n, n),)
        return args, ValueError
    if kind == "block_of_another_map":
        n = CFG.cell_n
        args[7] = args[7][:4] + (Block(0, 0, n, n, n + 2, n + 2),)
        return args, ValueError
    if kind == "cpu_tensors":
        return args, ValueError
    raise AssertionError(kind)


SHAPE_KINDS = ["layers_shape", "normal_shape", "total_shape", "t_shape", "pyramid_shape", "block_outside",
               "block_of_another_map"]


@pytest.mark.parametrize(
    "kind",
    ["float64", "float64_cube", "strided_cube", "strided_layers", "strided_counts"] + SHAPE_KINDS + ["cpu_tensors"],
)
def test_kernel_refuses_before_any_build(monkeypatch, kind):
    """The kernel's launch refuses what it does not take, CPU tensors last
    of all, without building the kernel or counting a launch."""

    def no_build():
        raise AssertionError("the kernel was built")

    monkeypatch.setattr(raycast.KERNEL, "load", no_build)
    args, error = _bad_arguments(kind)
    before = raycast.KERNEL.launches
    with pytest.raises(error):
        raycast.launch_polar_evaluate(*args)
    assert raycast.KERNEL.launches == before


@pytest.mark.parametrize("kind", SHAPE_KINDS)
def test_plain_version_refuses_the_same_shapes(kind):
    """The checks both versions share hold on the CPU path too."""
    args, error = _bad_arguments(kind)
    with pytest.raises(error):
        raycast.polar_evaluate(*args)


@pytest.mark.parametrize("pyramid", [False, True])
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(monkeypatch, pyramid):
    monkeypatch.setattr(raycast, "launch_polar_evaluate", None)  # never reached on the CPU
    args = _inputs(pyramid=pyramid)
    before = raycast.KERNEL.launches
    got = raycast.polar_evaluate(*args)
    assert torch.equal(got, raycast._polar_evaluate(*args))
    assert raycast.KERNEL.launches == before
    assert raycast.KERNEL.source == "polar_evaluate.cu"
    assert kernels.registered_kernels()[raycast.KERNEL.name] is raycast.KERNEL


def test_cpu_chunks_equal_one_pass(monkeypatch):
    """POLAR_EVAL_BYTES splits a CPU batch into chunks of maps; the maps come
    out as from one pass (here one map a chunk, with a pyramid)."""
    args = _inputs(b=3, pyramid=True)
    want = raycast._polar_evaluate(*args)
    monkeypatch.setattr(raycast, "POLAR_EVAL_BYTES", 1)
    assert torch.equal(raycast.polar_evaluate(*args), want)


def test_other_devices_are_refused():
    args = [x.to("meta") if isinstance(x, torch.Tensor) else x for x in _inputs()]
    with pytest.raises(ValueError, match="cuda or cpu"):
        raycast.polar_evaluate(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bucket_table_holds_the_inline_values(dtype):
    """The (5, S) table both versions read equals the per-bucket values as
    the evaluation wrote them inline, bit for bit."""
    S = 37
    step, res = CFG.ray_step, CFG.resolution
    phi_k = (torch.arange(S, dtype=dtype) + 0.5) * (math.pi / S) - math.pi / 2
    delta_k = step * torch.cos(phi_k)
    want = [torch.tan(phi_k), torch.cos(phi_k), torch.sin(phi_k), delta_k, (res**2) / torch.clamp(delta_k, min=1e-9)]
    got = raycast._bucket_table(S, step, res, dtype, torch.device("cpu"))
    assert got.shape == (5, S) and got.dtype == dtype
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_constants_match_the_source():
    """The constants the wrapper passes are those the kernel's ``Const``
    enumerates, one float32 each, in the same order as its comments."""
    with open(os.path.join(kernels.CSRC_DIR, "polar_evaluate.cu")) as f:
        src = f.read()
    body = re.search(r"enum Const : int \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"^\s*(k\w+),", body, re.M)
    consts = raycast._kernel_constants(CFG, CFG.azimuth_bins)
    assert names[-1] == "kOutlierVar" and len(names) == len(consts)
    assert consts[names.index("kStep")] == CFG.ray_step
    assert consts[names.index("kAzScale")] == CFG.azimuth_bins / (2.0 * math.pi)
    assert consts[names.index("kDecScale")] == CFG.cleanup_step * CFG.max_ray_length
    assert consts[names.index("kWallThresh")] == CFG.wall_num_thresh
