"""The dilation's dispatch and the kernel's argument checks, on the CPU.

The kernel itself (``csrc/dilation_fill.cu``) runs only on a card
(``tests/test_torch_cuda.py``); these tests need neither a card nor
``nvcc``. The plain version is held to the JAX package in
``tests/test_torch_ops.py``.
"""

import numpy as np
import pytest
import torch

from elevation_mapping_cupy_torch import kernels
from elevation_mapping_cupy_torch.ops import stencil
from elevation_mapping_cupy_torch.ops.geometry import Block

H, W, SIZE = 6, 9, 2


def _maps(b=2):
    rng = np.random.default_rng(0)
    height = torch.from_numpy(rng.normal(0.0, 1.0, (b, H, W)).astype(np.float32))
    mask = torch.from_numpy((rng.random((b, H, W)) < 0.4).astype(np.float32))
    return height, mask


def _edges(b=2, size=SIZE):
    return tuple(torch.zeros((b, 2, H, size)) for _ in range(2))


def _bad_arguments(kind):
    """(arguments of launch_dilation_fill, the error it must raise)."""
    height, mask = _maps()
    border = Block(0, 0, H, W, H, W + 5)
    if kind == "float64":
        return (height.double(), mask.double(), SIZE), TypeError
    if kind == "strided_rows":
        return (height.transpose(-1, -2), mask.transpose(-1, -2), SIZE), ValueError
    if kind == "strided_edges":
        left, right = _edges()
        return (height, mask, SIZE, border, (left.transpose(-1, -2).contiguous().transpose(-1, -2), right)), ValueError
    if kind == "edges_shape":
        return (height, mask, SIZE, border, _edges(size=SIZE + 1)), ValueError
    if kind == "mask_shape":
        return (height, mask[:1], SIZE), ValueError
    if kind == "block_shape":
        return (height, mask, SIZE, Block(0, 0, H + 1, W, H + 1, W)), ValueError
    if kind == "size":
        return (height, mask, W + 1), ValueError
    if kind == "border_without_edges":
        return (height, mask, SIZE, border), ValueError
    if kind == "cpu_tensors":
        return (height, mask, SIZE), ValueError
    raise AssertionError(kind)


@pytest.mark.parametrize(
    "kind",
    ["float64", "strided_rows", "strided_edges", "edges_shape", "mask_shape", "block_shape", "size",
     "border_without_edges", "cpu_tensors"],
)
def test_kernel_refuses_before_any_build(monkeypatch, kind):
    """The kernel's launch refuses what it does not take, CPU tensors last
    of all, without building the kernel or counting a launch."""

    def no_build():
        raise AssertionError("the kernel was built")

    monkeypatch.setattr(stencil.KERNEL, "load", no_build)
    args, error = _bad_arguments(kind)
    before = stencil.KERNEL.launches
    with pytest.raises(error):
        stencil.launch_dilation_fill(*args)
    assert stencil.KERNEL.launches == before


@pytest.mark.parametrize("kind", ["float64", "edges_shape", "mask_shape", "block_shape", "border_without_edges"])
def test_plain_version_refuses_the_same_shapes(kind):
    """The checks both versions share hold on the CPU path too."""
    args, error = _bad_arguments(kind)
    with pytest.raises(error):
        stencil.dilation_fill(*args)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(monkeypatch):
    monkeypatch.setattr(stencil, "launch_dilation_fill", None)  # never reached on the CPU
    height, mask = _maps()
    before = stencil.KERNEL.launches
    got = stencil.dilation_fill(height, mask, SIZE)
    want = stencil.dilation_fill_reference(height, mask, SIZE)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert stencil.KERNEL.launches == before
    assert stencil.KERNEL.source == "dilation_fill.cu"
    assert kernels.registered_kernels()[stencil.KERNEL.name] is stencil.KERNEL


def test_other_devices_are_refused():
    height, mask = (x.to("meta") for x in _maps())
    with pytest.raises(ValueError, match="cuda or cpu"):
        stencil.dilation_fill(height, mask, SIZE)
