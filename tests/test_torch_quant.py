"""The quantized collectives of the PyTorch port (mpi4dl_tpu_torch/quant)
against the JAX package's (mpi4dl_tpu/quant).

- Policy: the cases of ``test_quant.py``'s policy tests, on the port's
  copy of the grammar.
- Kernels: ``quantize`` payloads and scales and ``dequantize`` outputs
  bitwise equal to JAX's (jitted, as its engines run them) for int8, fp8
  and int4 (ragged tails, odd int4 widths, blocks of 4 and 256, fp32 and
  bf16 inputs); the error bound, NaN and Inf poisoning their block, zero
  blocks exact, int4 exact on its grid, bf16 kept.
- Collectives on four gloo ranks (one launch runs every case; the ranks
  run this file as their script and never import JAX): ``all_to_all`` and
  ``shift`` bitwise equal to JAX's ``quantized_all_to_all`` and
  ``quantized_ppermute`` on the virtual mesh, forward and backward (zero
  fill included); ``all_gather`` bitwise equal to JAX's jitted
  ``dequantize(quantize(tile))`` of each tile, concatenated (the composition stands in
  for JAX's own gather test, red on jax 0.9), its backward bitwise the raw
  gather's, as is the tile junction's; ``pmean`` on one axis and on two
  within one quantization step of its block of JAX's ``quantized_pmean``
  elementwise (the f32 sums of a shard may round the other way) and within
  ``test_quant.py``'s bound of the exact mean; the coarsening ring of
  ``respatial`` bitwise equal to JAX's quantized ``respatial`` per device.
"""

import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch.quant import QuantPolicy, dequantize, quant_error_bound, quantize
from mpi4dl_tpu_torch.quant.kernels import MODES, block_scales, payload_dim
from mpi4dl_tpu_torch.quant.policy import scope_quant_class

WORLD = 4
PERM = ((0, 1), (1, 2), (2, 3))


# ---------------------------------------------------------------------------
# Policy (test_quant.py:56-118).
# ---------------------------------------------------------------------------


def test_policy_parse_off_and_global_modes():
    assert QuantPolicy.parse(None) is None
    assert QuantPolicy.parse("off") is None
    assert QuantPolicy.parse("") is None
    p = QuantPolicy.parse("int8")
    assert p is not None and p.active
    assert all(p.mode(c) == "int8" for c in ("junction", "respatial", "grad", "handoff"))
    assert QuantPolicy.parse(p.spec()) == p
    assert p.spec() == "junction=int8,respatial=int8,grad=int8,handoff=int8"


def test_policy_parse_per_class_and_block():
    p = QuantPolicy.parse("junction=int4,grad=int8,block=128")
    assert p.mode("junction") == "int4" and p.mode("grad") == "int8"
    assert p.mode("respatial") is None and p.mode("handoff") is None
    assert p.block == 128
    assert QuantPolicy.parse(p.spec()) == p
    for bad in ("int7", "junktion=int8", "block=3", "block=0", "grad=int2"):
        with pytest.raises(ValueError):
            QuantPolicy.parse(bad)
    assert QuantPolicy.parse("junction=off") is None
    with pytest.raises(ValueError, match="unknown quant class"):
        p.mode("halo")


def test_policy_parse_order_independent():
    a = QuantPolicy.parse("junction=off,int8")
    b = QuantPolicy.parse("int8,junction=off")
    assert a == b and a.mode("junction") is None and a.mode("grad") == "int8"


def test_policy_hatch_override(monkeypatch):
    monkeypatch.setenv("MPI4DL_QUANT_COLLECTIVES", "fp8")
    assert QuantPolicy.resolve("int8").mode("junction") == "fp8"
    monkeypatch.setenv("MPI4DL_QUANT_COLLECTIVES", "off")
    assert QuantPolicy.resolve("int8") is None
    monkeypatch.delenv("MPI4DL_QUANT_COLLECTIVES")
    assert QuantPolicy.resolve("int8").mode("grad") == "int8"


def test_hot_scope_classes():
    assert scope_quant_class("a/junction_gather/b") == "junction"
    assert scope_quant_class("stage_lineup") == "junction"
    assert scope_quant_class("respatial_l1") == "respatial"
    assert scope_quant_class("grad_reduce") == "grad"
    assert scope_quant_class("tail_scan/stage_handoff") == "handoff"
    assert scope_quant_class("loss_reduce") is None
    assert scope_quant_class("cell03/conv") is None


@pytest.mark.parametrize("spec", ["int8", "junction=int4,grad=fp8,block=64",
                                  "int8,junction=off", "off", "handoff=int8"])
def test_policy_agrees_with_jax(spec, monkeypatch):
    """The port's copy of the grammar resolves every spec as JAX's does."""
    from mpi4dl_tpu.quant.policy import QuantPolicy as J

    monkeypatch.delenv("MPI4DL_QUANT_COLLECTIVES", raising=False)
    a, b = QuantPolicy.resolve(spec), J.resolve(spec)
    assert (a is None) == (b is None)
    if a is not None:
        assert a.spec() == b.spec() and a.block == b.block


# ---------------------------------------------------------------------------
# Kernels (test_quant.py:120-205) and bitwise parity with JAX.
# ---------------------------------------------------------------------------

KERNEL_CASES = [((4, 7, 300), 256), ((3, 513), 256), ((2, 5, 9), 4), ((2, 3, 8), 4),
                ((17,), 4)]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_quantize_dequantize_bitwise_jax(mode, dtype):
    """Bitwise against the JAX functions as its engines run them, under
    ``jax.jit`` (XLA turns the scales' ``absmax / qmax`` into a multiply
    by the f32 reciprocal; called eagerly they may differ in the last bit
    of a scale)."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.quant import kernels as jk

    rng = np.random.default_rng(0)
    for shape, block in KERNEL_CASES:
        x = (rng.standard_normal(shape)
             * rng.uniform(1e-2, 1e2, shape[:-1] + (1,))).astype(np.float32)
        x[..., :3] = 0.0
        xj = jnp.asarray(x).astype(getattr(jnp, dtype))
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        qj, sj = jax.jit(lambda t: jk.quantize(t, mode, block))(xj)
        qt, st = quantize(xt, mode, block)
        assert tuple(qt.shape) == qj.shape
        assert qt.shape[-1] == payload_dim(shape[-1], mode)
        np.testing.assert_array_equal(_bits(qt), np.asarray(qj).view(np.uint8),
                                      err_msg=f"{shape} {mode}")
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        yj = jax.jit(lambda a, b: jk.dequantize(a, b, mode, block, shape[-1], xj.dtype))(
            qj, sj)
        yt = dequantize(qt, st, mode, block, shape[-1], xt.dtype)
        assert yt.dtype == xt.dtype
        np.testing.assert_array_equal(_bits(yt), np.asarray(yj).view(np.uint8))


@pytest.mark.parametrize("mode", MODES)
def test_round_trip_error_bound(mode):
    rng = np.random.default_rng(1)
    block = 16
    for shape in [(3, 5, 7, 33), (4, 256), (1, 1, 1, 3), (17,), (2, 511)]:
        x = torch.from_numpy((rng.normal(size=shape)
                              * rng.uniform(1e-3, 1e3, size=shape)).astype(np.float32))
        q, s = quantize(x, mode, block)
        y = dequantize(q, s, mode, block, shape[-1], torch.float32)
        nb = -(-shape[-1] // block)
        pad = nb * block - shape[-1]
        err = torch.nn.functional.pad((x - y).abs(), (0, pad))
        ax = torch.nn.functional.pad(x.abs(), (0, pad))
        err_b = err.reshape(*shape[:-1], nb, block).amax(-1)
        amax_b = ax.reshape(*shape[:-1], nb, block).amax(-1)
        assert bool((err_b <= amax_b * quant_error_bound(mode) * 1.001 + 1e-12).all())


def test_block_scale_correctness():
    x = torch.arange(10, dtype=torch.float32).reshape(1, 10)
    np.testing.assert_allclose(block_scales(x, "int8", 4)[0].numpy(),
                               np.array([3.0, 7.0, 9.0]) / 127.0, rtol=1e-6)


def test_zero_blocks_round_trip_exact():
    x = torch.zeros((3, 40))
    for mode in MODES:
        q, s = quantize(x, mode, 16)
        assert (dequantize(q, s, mode, 16, 40, torch.float32) == 0).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_nonfinite_inputs_poison_their_block(mode, bad):
    x = torch.tensor([[1.0, bad, 2.0, 3.0, 5.0, 6.0, 7.0, 8.0]])
    q, s = quantize(x, mode, 4)
    y = dequantize(q, s, mode, 4, 8, torch.float32).numpy()
    assert not np.isfinite(y[0, :4]).any(), y
    np.testing.assert_allclose(y[0, 4:], [5, 6, 7, 8], rtol=0.1)


def test_int4_packing_round_trip_exact_on_grid():
    for c in (8, 9):
        vals = np.arange(-7, 8)[np.random.default_rng(0).integers(0, 15, (4, c))]
        x = torch.from_numpy((vals * 2.0).astype(np.float32))
        q, s = quantize(x, "int4", c + (c & 1))
        assert q.shape[-1] == payload_dim(c, "int4") == (c + 1) // 2
        y = dequantize(q, s, "int4", c + (c & 1), c, torch.float32)
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-6)


def test_bf16_round_trip_dtype_preserved():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0)).bfloat16()
    q, s = quantize(x, "int8", 32)
    assert dequantize(q, s, "int8", 32, 64, torch.bfloat16).dtype == torch.bfloat16


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown quant mode"):
        quantize(torch.zeros(4, 4), "int3", 4)


# ---------------------------------------------------------------------------
# Collectives: the rank side (no JAX).
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, workdir: Path) -> None:
    import torch.distributed as dist

    from mpi4dl_tpu_torch.parallel import tiles as T
    from mpi4dl_tpu_torch.quant import collectives as qc

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'rendezvous'}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=60))
    g = dist.group.WORLD
    inp = np.load(workdir / "inputs.npz")
    mine = lambda k: torch.from_numpy(inp[k][rank])
    out = {}
    for mode in MODES + ("off",):
        m = None if mode == "off" else mode
        x = mine("a2a_x").requires_grad_(True)
        y = qc.quantized_all_to_all(x, g, 0, 1, m, 16)
        (gx,) = torch.autograd.grad(y, x, mine("a2a_ct"))
        out[f"a2a_{mode}"], out[f"a2a_g_{mode}"] = y.detach().numpy(), gx.numpy()
        x = mine("pp_x").requires_grad_(True)
        y = qc.quantized_shift(x, g, PERM, m, 16)
        (gx,) = torch.autograd.grad(y, x, mine("pp_ct"))
        out[f"pp_{mode}"], out[f"pp_g_{mode}"] = y.detach().numpy(), gx.numpy()
        x = mine("ag_x").requires_grad_(True)
        y = qc.quantized_all_gather(x, g, 0, m, 16)
        (gx,) = torch.autograd.grad(y, x, torch.from_numpy(inp["ag_ct"]))
        out[f"ag_{mode}"], out[f"ag_g_{mode}"] = y.detach().numpy(), gx.numpy()
        tiles = T.ProcessGroupTiles(2, 2)
        x = mine("tile_x").requires_grad_(True)
        y = tiles.gather(x, m, 16, "junction")
        (gx,) = torch.autograd.grad(y, x, torch.from_numpy(inp["tile_ct"]))
        out[f"tile_{mode}"], out[f"tile_g_{mode}"] = y.detach().numpy(), gx.numpy()
        if m is None:
            continue
        out[f"pmean_{mode}"] = qc.quantized_pmean(mine("pm_x"), g, (4,), (0,), m, 64).numpy()
        out[f"pmean2_{mode}"] = qc.quantized_pmean(mine("pm2_x"), g, (2, 2), (0, 1), m,
                                                   32).numpy()
        base = T.ProcessGroupTiles(1, 4)
        out[f"ring_{mode}"] = T.respatial(mine("ring_x"), base, base.level(1, 2), m, 256,
                                          "respatial").numpy()
    qc.reset_wire_bytes()
    qc.quantized_all_gather(mine("ag_x"), g, 0, "int8", 16)
    out["bytes"] = np.array([qc.WIRE_BYTES["junction"], qc.RAW_BYTES["junction"]])
    np.savez(workdir / f"out{rank}.npz", **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Collectives: JAX on the virtual mesh, and the comparisons.
# ---------------------------------------------------------------------------


def _inputs(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        "a2a_x": f(4, 4, 4, 32), "a2a_ct": f(4, 1, 16, 32),
        "pp_x": f(4, 2, 40), "pp_ct": f(4, 2, 40),
        "ag_x": f(4, 2, 40), "ag_ct": f(8, 40),
        "tile_x": f(4, 1, 4, 4, 40), "tile_ct": f(1, 8, 8, 40),
        "pm_x": f(4, 1, 999) * 3.0, "pm2_x": f(4, 1, 130),
        "ring_x": f(4, 2, 8, 4, 8),
    }


@pytest.fixture(scope="module")
def rank_outputs(tmp_path_factory):
    from test_torch_ring import launch_gloo_ranks

    workdir = tmp_path_factory.mktemp("quant_ranks")
    inp = _inputs(np.random.default_rng(7))
    np.savez(workdir / "inputs.npz", **inp)
    launch_gloo_ranks("collectives", workdir, script=__file__)
    return inp, [np.load(workdir / f"out{r}.npz") for r in range(WORLD)]


def _jax_fn(fn, mesh, in_spec, out_spec):
    import jax

    from mpi4dl_tpu.compat import shard_map

    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(in_spec,), out_specs=out_spec))


def _mesh(devices8, shape=(4,), names=("spw",)):
    from jax.sharding import Mesh

    return Mesh(np.array(devices8[:4]).reshape(shape), names)


def _vjp(f, x, ct):
    import jax

    y, vjp = jax.vjp(f, x)
    return np.asarray(y), np.asarray(vjp(ct)[0])


@pytest.mark.parametrize("mode", MODES + ("off",))
def test_all_to_all_bitwise_jax(rank_outputs, devices8, mode):
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from mpi4dl_tpu.quant import quantized_all_to_all

    inp, outs = rank_outputs
    fn = ((lambda t: lax.all_to_all(t, "spw", 0, 1, tiled=True)) if mode == "off"
          else (lambda t: quantized_all_to_all(t, "spw", 0, 1, mode, 16)))
    f = _jax_fn(fn, _mesh(devices8), P("spw"), P("spw"))
    y, gx = _vjp(f, inp["a2a_x"].reshape(16, 4, 32), inp["a2a_ct"].reshape(4, 16, 32))
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out[f"a2a_{mode}"], y[r:r + 1], err_msg=str(r))
        np.testing.assert_array_equal(out[f"a2a_g_{mode}"], gx[4 * r:4 * r + 4])


@pytest.mark.parametrize("mode", MODES + ("off",))
def test_shift_bitwise_jax_with_zero_fill(rank_outputs, devices8, mode):
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from mpi4dl_tpu.quant import quantized_ppermute

    inp, outs = rank_outputs
    fn = ((lambda t: lax.ppermute(t, "spw", PERM)) if mode == "off"
          else (lambda t: quantized_ppermute(t, "spw", PERM, mode, 16)))
    f = _jax_fn(fn, _mesh(devices8), P("spw", None), P("spw", None))
    y, gx = _vjp(f, inp["pp_x"].reshape(8, 40), inp["pp_ct"].reshape(8, 40))
    np.testing.assert_array_equal(outs[0][f"pp_{mode}"], 0.0)
    np.testing.assert_array_equal(outs[3][f"pp_g_{mode}"], 0.0)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out[f"pp_{mode}"], y[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out[f"pp_g_{mode}"], gx[2 * r:2 * r + 2])


@pytest.mark.parametrize("mode", MODES)
def test_all_gather_is_the_jax_tile_composition_with_the_raw_backward(rank_outputs, mode):
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.quant import kernels as jk

    inp, outs = rank_outputs

    @jax.jit
    def rt(t):
        q, s = jk.quantize(t, mode, 16)
        return jk.dequantize(q, s, mode, 16, t.shape[-1], jnp.float32)

    want = np.concatenate([np.asarray(rt(t)) for t in inp["ag_x"]])
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out[f"ag_{mode}"], want, err_msg=str(r))
        np.testing.assert_array_equal(out[f"ag_g_{mode}"], out["ag_g_off"])
        # The tile junction: each tile decoded from its own encode, the
        # backward the raw gather's (this rank's own slice).
        tiles = [np.asarray(rt(t)) for t in inp["tile_x"]]
        full = np.concatenate([np.concatenate(tiles[0:2], axis=2),
                               np.concatenate(tiles[2:4], axis=2)], axis=1)
        np.testing.assert_array_equal(out[f"tile_{mode}"], full)
        np.testing.assert_array_equal(out[f"tile_g_{mode}"], out["tile_g_off"])
    raw = [np.concatenate(inp["ag_x"])] * WORLD
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["ag_off"], raw[r])


def test_all_gather_wire_bytes(rank_outputs):
    """A rank sends its int8 tile (2 x 40 payload + 2 x 3 f32 scales) to
    three ranks, beside the raw 2 x 40 x 4 bytes."""
    _, outs = rank_outputs
    for out in outs:
        assert out["bytes"].tolist() == [3 * (80 + 24), 3 * 320]


def _block_step(v, mode, block, n):
    """One quantization step of each element's block of the flat vector
    ``v`` as the last all_gather encodes it (padded to ``n·block``)."""
    size = v.size
    padded = n * block * -(-size // (n * block))
    a = np.pad(np.abs(v.reshape(-1)), (0, padded - size)).reshape(-1, block).max(1)
    return np.repeat(a * 2 * quant_error_bound(mode), block)[:size].reshape(v.shape)


@pytest.mark.parametrize("mode", MODES)
def test_pmean_matches_jax_within_one_step(rank_outputs, devices8, mode):
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from mpi4dl_tpu.quant import quantized_pmean

    inp, outs = rank_outputs
    cases = [("pmean", "pm_x", (4,), ("spw",), 64, 2),
             ("pmean2", "pm2_x", (2, 2), ("data", "spw"), 32, 4)]
    for key, xk, shape, names, block, k in cases:
        mesh = _mesh(devices8, shape, names)
        axes = names if len(names) > 1 else names[0]
        spec = P(names if len(names) > 1 else names[0], None)
        x = inp[xk].reshape(4, -1)
        q = np.asarray(_jax_fn(lambda t: quantized_pmean(t, axes, mode, block), mesh,
                               spec, spec)(x))
        exact = np.asarray(_jax_fn(lambda t: lax.pmean(t, axes), mesh, spec, spec)(x))
        n = shape[-1]
        for r, out in enumerate(outs):
            got = out[f"{key}_{mode}"].reshape(-1)
            step = _block_step(q[r], mode, block, n)
            assert (np.abs(got - q[r]) <= step * 1.001 + 1e-12).all(), (key, r)
            bound = k * np.abs(x).max() * quant_error_bound(mode) * 1.01
            assert np.abs(got - exact[r]).max() <= bound, (key, r)
            np.testing.assert_array_equal(got, outs[0][f"{key}_{mode}"].reshape(-1))


@pytest.mark.parametrize("mode", MODES)
def test_respatial_ring_bitwise_jax(rank_outputs, devices8, mode):
    """The coarsening ring (4 tiles → 2, rep 1 → 2) of ``test_quant.py``'s
    ``test_respatial_quantized_within_bound``: every rank bitwise JAX's
    device, and within JAX's bound of the exact move."""
    from jax.sharding import PartitionSpec as P

    from mpi4dl_tpu.layer_ctx import SpatialCtx
    from mpi4dl_tpu.parallel.spatial import respatial

    inp, outs = rank_outputs
    a, b = SpatialCtx(axis_w="spw", grid_w=4, rep_w=1), SpatialCtx(axis_w="spw", grid_w=2,
                                                                   rep_w=2)
    spec = P(None, None, "spw", None)
    x = np.concatenate(list(inp["ring_x"]), axis=2)
    pol = QuantPolicy.parse(f"respatial={mode}")
    q = np.asarray(_jax_fn(lambda t: respatial(t, a, b, quant=pol), _mesh(devices8),
                           spec, spec)(x))
    raw = np.asarray(_jax_fn(lambda t: respatial(t, a, b), _mesh(devices8), spec, spec)(x))
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out[f"ring_{mode}"], q[:, :, 8 * r:8 * r + 8])
    got = np.concatenate([o[f"ring_{mode}"] for o in outs], axis=2)
    assert np.abs(got - raw).max() <= np.abs(x).max() * quant_error_bound(mode) * 1.01


if __name__ == "__main__":
    _job, _rank, _world, _dir = sys.argv[1:5]
    _rank_main(int(_rank), int(_world), Path(_dir))
