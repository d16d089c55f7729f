"""The port's halo exchange (mpi4dl_tpu_torch/ops/halo.py) on the
one-process tile grid, against the JAX package's ``halo_exchange_2d`` in
``shard_map`` on the virtual CPU mesh and against the globally zero-padded
image — the arange fixture of ``tests/test_halo.py``, whose pixel values
encode their global position.  Every comparison is exact, as the JAX
test's is.  The process-group backend runs the same exchange in
``tests/test_torch_d2.py``'s gloo ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mpi4dl_tpu.compat import shard_map
from mpi4dl_tpu.mesh import MeshSpec, build_mesh
from mpi4dl_tpu.ops.halo import HaloSpec as JHaloSpec, halo_exchange_2d as j_exchange
from mpi4dl_tpu_torch.ops.halo import HaloSpec, halo_exchange_1d, halo_exchange_2d
from mpi4dl_tpu_torch.parallel.tiles import TileGrid

GRIDS = {"square": (2, 2), "horizontal": (4, 1), "vertical": (1, 4)}


def arange_image(h, w, c=1, n=1):
    return np.arange(1, n * h * w * c + 1, dtype=np.float32).reshape(n, h, w, c)


def expected_windows(img, halo, grid_h, grid_w):
    """Per tile, the window of the globally zero-padded image it must hold
    after the exchange (unsharded dims unpadded)."""
    ph = halo if grid_h > 1 else 0
    pw = halo if grid_w > 1 else 0
    padded = np.pad(img, ((0, 0), (ph, ph), (pw, pw), (0, 0)))
    th, tw = img.shape[1] // grid_h, img.shape[2] // grid_w
    return [padded[:, r * th:(r + 1) * th + 2 * ph, c * tw:(c + 1) * tw + 2 * pw]
            for r in range(grid_h) for c in range(grid_w)]


def _port_exchange(img, halo, grid_h, grid_w):
    tiles = TileGrid(grid_h, grid_w)
    out = halo_exchange_2d(
        tiles.scatter(torch.from_numpy(img)),
        HaloSpec.symmetric(halo if grid_h > 1 else 0),
        HaloSpec.symmetric(halo if grid_w > 1 else 0),
        "sph" if grid_h > 1 else None, "spw" if grid_w > 1 else None,
        grid_h, grid_w, tiles)
    return list(tiles.per_tile(out).numpy())


def _jax_exchange(img, halo, grid_h, grid_w):
    mesh = build_mesh(MeshSpec(sph=grid_h, spw=grid_w), jax.devices()[:grid_h * grid_w])
    axis_h = "sph" if grid_h > 1 else None
    axis_w = "spw" if grid_w > 1 else None
    spec = P(None, axis_h, axis_w, None)

    def ex(tile):
        return j_exchange(tile, JHaloSpec.symmetric(halo if grid_h > 1 else 0),
                          JHaloSpec.symmetric(halo if grid_w > 1 else 0),
                          axis_h, axis_w, grid_h, grid_w)

    out = jax.jit(shard_map(ex, mesh=mesh, in_specs=spec, out_specs=spec))(
        jnp.asarray(img))
    th = out.shape[1] // grid_h
    tw = out.shape[2] // grid_w
    out = np.asarray(out)
    return [out[:, r * th:(r + 1) * th, c * tw:(c + 1) * tw]
            for r in range(grid_h) for c in range(grid_w)]


@pytest.mark.parametrize("halo", [1, 2, 3])
@pytest.mark.parametrize("slice_method", ["vertical", "horizontal", "square"])
def test_halo_exchange_matches_zero_padded_window_and_jax(devices8, slice_method, halo):
    grid_h, grid_w = GRIDS[slice_method]
    img = arange_image(16, 16, c=2, n=2)
    got = _port_exchange(img, halo, grid_h, grid_w)
    want = expected_windows(img, halo, grid_h, grid_w)
    ref = _jax_exchange(img, halo, grid_h, grid_w)
    assert len(got) == len(want) == len(ref) == 4
    for k, (g, w, r) in enumerate(zip(got, want, ref)):
        np.testing.assert_array_equal(g, w, err_msg=f"tile {k}")
        np.testing.assert_array_equal(g, r, err_msg=f"tile {k} vs JAX")


def test_halo_exchange_1d_asymmetric():
    img = arange_image(8, 4)
    tiles = TileGrid(4, 1)
    out = halo_exchange_1d(tiles.scatter(torch.from_numpy(img)), 1, "sph", 4,
                           HaloSpec(2, 1), tiles)
    padded = np.pad(img, ((0, 0), (2, 1), (0, 0), (0, 0)))
    for k, tile in enumerate(tiles.per_tile(out).numpy()):
        np.testing.assert_array_equal(tile, padded[:, k * 2:k * 2 + 5])


def test_halo_grad_is_the_exchange_transposed():
    """The gradient of a halo read lands on the tile that owns the pixel:
    rows next to a tile boundary are read twice, image-border rows once
    (``tests/test_halo.py::test_halo_grad_flows_back``)."""
    tiles = TileGrid(4, 1)
    x = torch.ones((1, 8, 2, 1), requires_grad=True)
    ext = halo_exchange_1d(tiles.scatter(x), 1, "sph", 4, HaloSpec.symmetric(1), tiles)
    ext.sum().backward()
    np.testing.assert_array_equal(x.grad[0, :, 0, 0].numpy(),
                                  np.array([1, 2, 2, 2, 2, 2, 2, 1], np.float32))


def test_halo_wider_than_the_tile_raises():
    tiles = TileGrid(4, 1)
    x = tiles.scatter(torch.zeros((1, 8, 4, 1)))
    with pytest.raises(ValueError, match="exceeds local tile extent"):
        halo_exchange_1d(x, 1, "sph", 4, HaloSpec.symmetric(3), tiles)


def test_scatter_gather_round_trip():
    img = torch.from_numpy(arange_image(8, 12, c=3, n=2))
    for grid in GRIDS.values():
        tiles = TileGrid(*grid)
        assert torch.equal(tiles.gather(tiles.scatter(img)), img)
