"""Kernel K1 (``scatter_add_streams``) of the PyTorch port.

On the CPU the wrapper runs the kernel's plain PyTorch version; these tests
hold it to the JAX package's Pallas kernel (``mxu_scatter_add_2d`` in
interpret mode) and to a float64 loop, with B1's contract
(tests/test_pallas_scatter.py): integer streams bit-exact, value streams
within 2e-4. The kernel itself needs the card: tests/test_torch_cuda.py
holds it to this plain version there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elevation_mapping_cupy_tpu.ops import scatter as jscatter
from elevation_mapping_cupy_tpu.ops.pallas_scatter import _call_pallas_batched, mxu_scatter_add_2d

from elevation_mapping_cupy_torch import kernels
from elevation_mapping_cupy_torch.ops import cuda_scatter
from elevation_mapping_cupy_torch.ops import scatter as tscatter


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _loop(flat, mask, vals, n_cells):
    """float64 loop: vals (K, N) -> (K, n_cells)."""
    out = np.zeros((vals.shape[0], n_cells), np.float64)
    for i in range(vals.shape[1]):
        if mask[i]:
            out[:, flat[i]] += vals[:, i]
    return out


def _streams(rng, n, k, exact):
    vals = rng.standard_normal((k, n)).astype(np.float32)
    for s, e in enumerate(exact):
        if e:
            vals[s] = rng.integers(0, 3, n)  # flags and small counts
    return vals


@pytest.mark.parametrize("exact", [(True, True), (False, False, True, True), (False, True, False)])
def test_plain_version_matches_jax_kernel_and_loop(rng, exact):
    h, w, n = 37, 52, 3000
    k = len(exact)
    rows = rng.integers(0, h, n).astype(np.int32)
    cols = rng.integers(0, w, n).astype(np.int32)
    mask = rng.random(n) > 0.2
    vals = _streams(rng, n, k, exact)
    flat = rows * w + cols

    out = cuda_scatter.scatter_add_streams(
        torch.from_numpy(flat[None]), torch.from_numpy(mask[None]), torch.from_numpy(vals[None]), h * w
    )[0].numpy()
    # the JAX kernel takes pre-zeroed values for masked points (scatter.py:134-139)
    jvals = np.where(mask[None], vals, 0.0).T.astype(np.float32)
    jout = np.asarray(
        mxu_scatter_add_2d(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(jvals), h, w, exact, interpret=True)
    ).reshape(k, h * w)
    ref = _loop(flat, mask, vals, h * w)
    for s, e in enumerate(exact):
        if e:
            np.testing.assert_array_equal(out[s], ref[s])
            np.testing.assert_array_equal(out[s], jout[s])
        else:
            np.testing.assert_allclose(out[s], ref[s], atol=2e-4)
            np.testing.assert_allclose(out[s], jout[s], atol=2e-4)


def test_batched_launch_matches_jax_batched_kernel(rng):
    """B=4 in one call: each map's sums stay in its own output."""
    b, h, w, n = 4, 12, 18, 600
    exact = (False, True, False)
    rows = rng.integers(0, h, (b, n)).astype(np.int32)
    cols = rng.integers(0, w, (b, n)).astype(np.int32)
    vals = np.stack([_streams(rng, n, 3, exact) for _ in range(b)])  # (B, K, N)
    mask = np.ones((b, n), bool)
    out = cuda_scatter.scatter_add_streams(
        torch.from_numpy(rows * w + cols), torch.from_numpy(mask), torch.from_numpy(vals), h * w
    ).numpy()
    jout = np.asarray(
        _call_pallas_batched(
            jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals.transpose(0, 2, 1)), h, w, exact, True
        )
    ).reshape(b, 3, h * w)
    assert out.shape == (b, 3, h * w)
    np.testing.assert_array_equal(out[:, 1], jout[:, 1])
    np.testing.assert_allclose(out, jout, atol=2e-4)
    for i in range(b):
        np.testing.assert_allclose(out[i], _loop(rows[i] * w + cols[i], mask[i], vals[i], h * w), atol=2e-4)


def test_wide_stream_set(rng):
    """K=7 value streams (21 bf16 parts on the TPU: two MXU launches there,
    one launch here)."""
    h, w, n, k = 16, 24, 800, 7
    rows = rng.integers(0, h, n).astype(np.int32)
    cols = rng.integers(0, w, n).astype(np.int32)
    vals = rng.standard_normal((k, n)).astype(np.float32)
    mask = np.ones(n, bool)
    out = tscatter.scatter_add_streams_2d(
        h, w, torch.from_numpy(rows * w + cols), [torch.from_numpy(v) for v in vals],
        torch.from_numpy(mask), (False,) * k,
    ).numpy()
    jout = np.asarray(
        mxu_scatter_add_2d(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals.T), h, w, (False,) * k, interpret=True)
    )
    assert out.shape == (k, h, w)
    np.testing.assert_allclose(out, jout, atol=2e-4)
    np.testing.assert_allclose(out.reshape(k, -1), _loop(rows * w + cols, mask, vals, h * w), atol=2e-4)


def test_zero_points():
    out = cuda_scatter.scatter_add_streams(
        torch.zeros((1, 0), dtype=torch.int32), torch.zeros((1, 0), dtype=torch.bool),
        torch.zeros((1, 2, 0)), 30,
    )
    assert out.shape == (1, 2, 30) and not out.any()
    jout = mxu_scatter_add_2d(
        jnp.zeros((0,), jnp.int32), jnp.zeros((0,), jnp.int32), jnp.zeros((0, 2)), 5, 6, (True, True), interpret=True
    )
    np.testing.assert_array_equal(out[0].numpy().reshape(2, 5, 6), np.asarray(jout))


def test_mask_convention_and_out_of_range(rng):
    """A masked point adds nothing anywhere (the JAX router's 'neutral value
    at cell 0'), and an index outside the grid is dropped as XLA drops it."""
    n_cells = 50
    idx = np.array([3, 3, 0, 7, -1, 50, 49], np.int32)
    mask = np.array([True, False, False, True, True, True, True])
    vals = np.array([[1.5, 100.0, 100.0, 2.0, 9.0, 9.0, 4.0]], np.float32)
    out = cuda_scatter.scatter_add_streams(
        torch.from_numpy(idx[None]), torch.from_numpy(mask[None]), torch.from_numpy(vals[None]), n_cells
    )[0, 0].numpy()
    want = np.zeros(n_cells, np.float32)
    want[3], want[7], want[49] = 1.5, 2.0, 4.0
    np.testing.assert_array_equal(out, want)

    # the router's masking matches the JAX router's on the same inputs
    h = w = 10
    flat = rng.integers(0, h * w, 400).astype(np.int32)
    m = rng.random(400) > 0.5
    v1 = rng.standard_normal(400).astype(np.float32)
    v2 = (rng.random(400) > 0.5).astype(np.float32)
    t_out = tscatter.scatter_add_streams_2d(
        h, w, torch.from_numpy(flat), [torch.from_numpy(v1), torch.from_numpy(v2)], torch.from_numpy(m), (False, True)
    ).numpy()
    j_out = np.asarray(
        jscatter.scatter_add_streams_2d(h, w, jnp.asarray(flat), [jnp.asarray(v1), jnp.asarray(v2)], jnp.asarray(m), (False, True))
    )
    np.testing.assert_array_equal(t_out[1], j_out[1])
    np.testing.assert_allclose(t_out, j_out, atol=2e-4)
    t_add = tscatter.scatter_add(h * w, torch.from_numpy(flat), torch.from_numpy(v1), torch.from_numpy(m)).numpy()
    j_add = np.asarray(jscatter.scatter_add(h * w, jnp.asarray(flat), jnp.asarray(v1), jnp.asarray(m)))
    np.testing.assert_allclose(t_add, j_add, atol=2e-4)


def test_scatter_min_matches_jax(rng):
    n_cells = 64
    idx = rng.integers(0, n_cells, 500).astype(np.int32)
    vals = rng.standard_normal(500).astype(np.float32)
    mask = rng.random(500) > 0.3
    t_out = tscatter.scatter_min(n_cells, torch.from_numpy(idx), torch.from_numpy(vals), torch.from_numpy(mask), np.inf)
    j_out = jscatter.scatter_min(n_cells, jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(mask), jnp.inf)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))


def test_wrapper_checks_and_cpu_path_does_not_count():
    """The wrapper refuses what the kernel does not take, and the CPU path
    (the plain version) never counts as a kernel launch."""
    before = cuda_scatter.KERNEL.launches
    idx = torch.zeros((1, 4), dtype=torch.int32)
    mask = torch.ones((1, 4), dtype=torch.bool)
    with pytest.raises(TypeError):
        cuda_scatter.scatter_add_streams(idx.long(), mask, torch.ones((1, 1, 4)), 8)
    with pytest.raises(TypeError):
        cuda_scatter.scatter_add_streams(idx, mask, torch.ones((1, 1, 4), dtype=torch.float64), 8)
    with pytest.raises(ValueError):
        cuda_scatter.scatter_add_streams(idx, mask, torch.ones((1, 4, 1)), 8)
    cuda_scatter.scatter_add_streams(idx, mask, torch.ones((1, 1, 4)), 8)
    assert cuda_scatter.KERNEL.launches == before
    assert cuda_scatter.KERNEL.source == "scatter_add.cu"
    assert cuda_scatter.KERNEL.name in kernels.registered_kernels()



def test_scatter_or_matches_jax(rng):
    """scatter_or ("any point landed here") against the JAX package's."""
    idx = rng.integers(0, 300, 2000).astype(np.int32)
    mask = rng.random(2000) > 0.6
    want = jscatter.scatter_or(300, jnp.asarray(idx), jnp.asarray(mask))
    got = tscatter.scatter_or(300, torch.from_numpy(idx), torch.from_numpy(mask))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < 300


@pytest.mark.parametrize("fill", [2**31 - 1, 5000])
def test_smallest_unique_batched_rows(rng, fill):
    """The static unique over a batch: each row is jnp.unique of that row
    with a size and a fill, whatever the other rows hold."""
    cand = rng.integers(0, 50, (4, 300))
    cand[1, :] = 7                  # one distinct value
    cand[2] = rng.integers(0, 4000, 300)  # more distinct values than the size
    size = 40
    got = tscatter.smallest_unique(torch.from_numpy(cand), size, fill)
    assert got.shape == (4, size)
    for b in range(4):
        want = jnp.unique(jnp.asarray(cand[b]), size=size, fill_value=fill)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
        np.testing.assert_array_equal(got[b].numpy(), tscatter.smallest_unique(torch.from_numpy(cand[b]), size, fill).numpy())
