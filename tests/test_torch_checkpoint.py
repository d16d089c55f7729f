"""Checkpoint / restore of the port (mpi4dl_tpu_torch/checkpoint.py) against
the JAX package's (mpi4dl_tpu/checkpoint.py).

The first part is the counterpart of tests/test_checkpoint.py, case for
case, on torch states (its two pipeline cases, which are red on this jax,
are held by the runner tests in test_torch_runner_data.py instead): resume
is bit-identical, manifests carry CRC32s and fingerprints, the walk skips
torn or corrupt checkpoints, the v2 format is shard-native with global
offsets (a leaf the JAX package wrote in several shards is reassembled), a
layout change restores elastically and an identity change never does.  Then the two packages against each other: the fingerprints
are the same hex strings for the same flags, and a TrainState checkpoint
written by one package restores in the other with every leaf bitwise
equal, in both formats (bfloat16 parameters in the sharded format only:
the JAX package cannot read its own bfloat16 npz leaves back, numpy has no
cast for them).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu import checkpoint as jck
from mpi4dl_tpu.resilience import corrupt_file
from mpi4dl_tpu_torch import checkpoint as tck
from mpi4dl_tpu_torch import params as tparams
from mpi4dl_tpu_torch.checkpoint import (
    CheckpointInvalid, CheckpointManager, CheckpointMismatch, config_fingerprint, load_arrays, restore_state, save_state,
    split_config_fingerprint,
)
from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step


def _w(*shape, fill=1.0):
    return torch.full(shape, float(fill))


def _resnet(seed=0, dtype=torch.float32):
    from mpi4dl_tpu_torch.models import get_resnet_v2

    return get_resnet_v2((2, 32, 32, 3), depth=11, num_classes=10, device="cpu",
                         seed=seed, dtype=dtype)


def _leaves_equal(a, b):
    la, lb = tck.state_leaves(a), tck.state_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x.full(), y.full())


# ---------------------------------------------------------------------------
# Counterparts of tests/test_checkpoint.py.
# ---------------------------------------------------------------------------


def test_simple_state_roundtrip(tmp_path):
    model = _resnet()
    opt = Optimizer("sgd", lr=0.01, momentum=0.9)
    step = make_train_step(model, opt)
    state = TrainState.create(model, opt)
    g = torch.Generator().manual_seed(1)
    x, y = torch.randn((2, 32, 32, 3), generator=g), torch.tensor([0, 1])
    state, _ = step(state, x, y)
    path = str(tmp_path / "ckpt_1.npz")
    save_state(path, state, 1)

    # A fresh template (as a resumed process builds it), then restore.
    other = _resnet(seed=5)
    template = TrainState.create(other, opt)
    restored = restore_state(path, template)
    assert restored is template and restored.step == 1
    _leaves_equal(restored, state)

    # Continue training from both: identical trajectories.
    s1, m1 = step(state, x, y)
    s2, m2 = make_train_step(other, opt)(restored, x, y)
    assert float(m1["loss"]) == float(m2["loss"])
    _leaves_equal(s1, s2)


def test_manager_keep_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for sid in (1, 2, 3):
        mgr.save({"w": _w(3)}, step_id=sid)
    assert mgr.latest_path().endswith("ckpt_3")
    assert sorted(os.listdir(tmp_path)) == ["ckpt_2", "ckpt_3"]


def test_manager_npz_format_compat(tmp_path):
    v1 = CheckpointManager(str(tmp_path), format="npz")
    v1.save({"w": torch.arange(3.0)}, step_id=1)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_1.npz"]
    mixed = CheckpointManager(str(tmp_path))
    mixed.save({"w": torch.arange(3.0) * 2}, step_id=2)
    state, step_id = mixed.restore_latest({"w": torch.zeros(3)})
    assert step_id == 2
    corrupt_file(mixed.latest_path())  # the newest (sharded) falls back to v1
    state, step_id = mixed.restore_latest({"w": torch.zeros(3)})
    assert step_id == 1
    np.testing.assert_array_equal(state["w"].numpy(), np.arange(3.0))


def test_restore_rejects_mismatched_shapes(tmp_path):
    path = str(tmp_path / "ckpt_1.npz")
    save_state(path, {"w": _w(3)}, 1)
    with pytest.raises(ValueError):
        restore_state(path, {"w": _w(4)})


def test_manifest_step_id_roundtrip(tmp_path):
    path = str(tmp_path / "ckpt_7.npz")
    save_state(path, {"w": torch.arange(8.0)}, 7, fingerprint="abcd")
    arrays, step_id = load_arrays(path, expected_fingerprint="abcd")
    assert step_id == 7
    np.testing.assert_array_equal(arrays["leaf_0"].numpy(), np.arange(8.0))


@pytest.mark.parametrize("fmt", ["npz", "sharded"])
def test_manifest_detects_bit_corruption(tmp_path, fmt):
    mgr = CheckpointManager(str(tmp_path), format=fmt)
    path = mgr.save({"w": torch.arange(64.0)}, 1)
    corrupt_file(path)
    with pytest.raises(CheckpointInvalid):
        load_arrays(path)


def test_fingerprint_mismatch_rejected(tmp_path):
    path = str(tmp_path / "ckpt_1.npz")
    save_state(path, {"w": _w(3)}, 1, fingerprint="aaaa")
    with pytest.raises(CheckpointInvalid):
        load_arrays(path, expected_fingerprint="bbbb")
    _, step_id = load_arrays(path)  # no expected fingerprint: accepted
    assert step_id == 1


def test_restore_latest_mismatch_is_a_hard_error(tmp_path):
    CheckpointManager(str(tmp_path), fingerprint="aaaa").save({"w": _w(3)}, step_id=5)
    with pytest.raises(CheckpointMismatch):
        CheckpointManager(str(tmp_path), fingerprint="bbbb").restore_latest({"w": _w(3)})
    with pytest.raises(CheckpointMismatch):  # wrong template leaf shapes
        CheckpointManager(str(tmp_path), fingerprint="aaaa").restore_latest({"w": _w(4)})


def test_config_fingerprint_ignores_volatile_fields():
    from mpi4dl_tpu_torch.config import ParallelConfig

    a = ParallelConfig(checkpoint_dir="/x", verbose=True, num_epochs=2)
    b = ParallelConfig(checkpoint_dir="/y", verbose=False, num_epochs=4)
    c = ParallelConfig(batch_size=64)
    assert config_fingerprint(a) == config_fingerprint(b)
    assert config_fingerprint(a) != config_fingerprint(c)
    assert config_fingerprint({"s": {"b", "a", "c"}}) == config_fingerprint(
        {"s": {"c", "a", "b"}})


def test_restore_latest_require_raises_when_all_invalid(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    corrupt_file(mgr.save({"w": _w(3)}, step_id=1))
    with pytest.raises(CheckpointInvalid):
        mgr.restore_latest({"w": _w(3)}, require=True)
    with pytest.raises(CheckpointInvalid):
        CheckpointManager(str(tmp_path / "empty")).restore_latest({"w": _w(3)}, require=True)


def test_restore_latest_empty_dir_fresh_start(tmp_path):
    template = {"w": _w(3)}
    state, step_id = CheckpointManager(str(tmp_path)).restore_latest(template)
    assert step_id == 0 and state is template


def _two_shard_checkpoint(mgr, step_id, leaf_w, leaf_rep):
    """A checkpoint whose first leaf is written in two row blocks at their
    global offsets, as the JAX package writes a leaf sharded over devices
    (the port writes one shard a leaf)."""
    txn = mgr.begin_save(step_id)
    txn.add_leaf(0, {"shape": list(leaf_w.shape), "dtype": "float32"})
    half = leaf_w.shape[0] // 2
    txn.add_shard(0, (0, 0), leaf_w[:half])
    txn.add_shard(0, (half, 0), leaf_w[half:])
    txn.add_leaf(1, {"shape": list(leaf_rep.shape), "dtype": "float32"})
    txn.add_shard(1, (0,), leaf_rep)
    mgr.finish_save(txn)
    return txn.path


def test_sharded_manifest_offsets_and_crcs(tmp_path):
    """Shards are keyed by GLOBAL offsets, each with its own CRC32; the
    loader reassembles a leaf from them, as the JAX package's does."""
    w = torch.arange(64.0).reshape(8, 8)
    mgr = CheckpointManager(str(tmp_path))
    path = _two_shard_checkpoint(mgr, 4, w, torch.arange(6.0))
    manifest = json.load(open(os.path.join(path, tck.SHARD_MANIFEST)))
    assert manifest["schema"] == 2 and manifest["step_id"] == 4
    assert [len(l["shards"]) for l in manifest["leaves"]] == [2, 1]
    assert [s["offset"] for s in manifest["leaves"][0]["shards"]] == [[0, 0], [4, 0]]
    assert all(isinstance(s["crc32"], int) for s in manifest["leaves"][0]["shards"])
    stats = mgr.last_save_stats
    assert stats.shards == 3 and stats.bytes == (64 + 6) * 4 and stats.write_ms > 0
    arrays, step_id = tck.load_sharded_arrays(path)
    assert step_id == 4
    np.testing.assert_array_equal(arrays["leaf_0"].numpy(), w.numpy())
    jarrays, _ = jck.load_sharded_arrays(path)  # the JAX package reads the same
    for k, v in arrays.items():
        np.testing.assert_array_equal(jarrays[k], v.numpy())
    # A save of whole tensors: one shard a leaf, the stats of every shard.
    mgr.save({"w": w, "rep": torch.arange(6.0)}, 5)
    assert mgr.last_save_stats.shards == 2 and mgr.last_save_stats.gather_ms >= 0


def test_elastic_restore_cross_mesh(tmp_path):
    """A checkpoint saved under one layout (a leaf in two shards) restores
    bit-identically into a state of another layout; identity must match,
    layout skew is allowed and flagged."""
    from mpi4dl_tpu_torch.mesh import MeshSpec

    spec_a, spec_b = MeshSpec(stage=2, sph=2, spw=2), MeshSpec(stage=2, sph=4, spw=1)
    cfg_a = {"model": "resnet", "seed": 0, "slice_method": "square", "parts": 4}
    cfg_b = {"model": "resnet", "seed": 0, "slice_method": "horizontal", "parts": 2}
    ia, la, da = split_config_fingerprint(cfg_a, spec_a)
    ib, lb, db = split_config_fingerprint(cfg_b, spec_b)
    assert ia == ib and la != lb
    w, t = torch.arange(64.0).reshape(8, 8), torch.arange(16.0).reshape(4, 4)
    _two_shard_checkpoint(CheckpointManager(str(tmp_path), identity=ia, layout=la,
                                            layout_desc=da), 7, t, w.reshape(-1))
    template = {"a": torch.zeros(4, 4), "b": torch.zeros(64)}
    restorer = CheckpointManager(str(tmp_path), identity=ib, layout=lb, layout_desc=db)
    state, step_id = restorer.restore_latest(template)
    assert step_id == 7 and restorer.last_restore.elastic
    assert restorer.last_restore.saved_layout["slice_method"] == "square"
    np.testing.assert_array_equal(state["a"].numpy(), t.numpy())
    np.testing.assert_array_equal(state["b"].numpy(), w.reshape(-1).numpy())
    again = CheckpointManager(str(tmp_path), identity=ia, layout=la)
    _, sid = again.restore_latest({"a": torch.zeros(4, 4), "b": torch.zeros(64)})
    assert sid == 7 and not again.last_restore.elastic


def test_elastic_restore_identity_mismatch_still_hard(tmp_path):
    ia, la, da = split_config_fingerprint({"model": "resnet", "parts": 2})
    ib, lb, _ = split_config_fingerprint({"model": "amoebanet", "parts": 4})
    CheckpointManager(str(tmp_path), identity=ia, layout=la, layout_desc=da).save(
        {"w": _w(3)}, 1)
    with pytest.raises(CheckpointMismatch):
        CheckpointManager(str(tmp_path), identity=ib, layout=lb).restore_latest({"w": _w(3)})


def test_elastic_restore_shape_change_is_typed_error(tmp_path):
    ia, la, da = split_config_fingerprint({"model": "r", "spatial_until": 5})
    _, lb, _ = split_config_fingerprint({"model": "r", "spatial_until": 9})
    CheckpointManager(str(tmp_path), identity=ia, layout=la, layout_desc=da).save(
        {"buf": _w(6)}, 1)
    with pytest.raises(CheckpointMismatch, match="not leaf-shape-preserving"):
        CheckpointManager(str(tmp_path), identity=ia, layout=lb).restore_latest(
            {"buf": _w(8)})


def test_quant_policy_change_is_reshape_not_drift(tmp_path):
    i8, l8, d8 = split_config_fingerprint(
        {"model": "r"}, extra_layout={"quant_resolved": "junction=int8"})
    ioff, loff, doff = split_config_fingerprint(
        {"model": "r"}, extra_layout={"quant_resolved": "off"})
    assert i8 == ioff and l8 != loff
    CheckpointManager(str(tmp_path), identity=i8, layout=l8, layout_desc=d8).save(
        {"w": _w(3)}, 2)
    r = CheckpointManager(str(tmp_path), identity=ioff, layout=loff, layout_desc=doff)
    _, sid = r.restore_latest({"w": torch.zeros(3)})
    assert sid == 2 and r.last_restore.elastic
    assert r.last_restore.saved_layout["quant_resolved"] == "junction=int8"


def test_cheap_validation_reads_no_array_bytes(tmp_path, monkeypatch):
    reads = []
    real = tck._read_shard_bytes
    monkeypatch.setattr(tck, "_read_shard_bytes", lambda p: (reads.append(p) or real(p)))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"w": torch.arange(1024.0)}, 1)
    p2 = mgr.save({"w": torch.arange(1024.0) * 2}, 2)
    shard = next(os.path.join(p2, f) for f in sorted(os.listdir(p2)) if f.endswith(".bin"))
    with open(shard, "r+b") as f:  # a torn shard
        f.truncate(os.path.getsize(shard) // 2)
    _, step_id = mgr.restore_latest({"w": torch.zeros(1024)})
    assert step_id == 1
    assert len(reads) == 1 and os.path.dirname(reads[0]).endswith("ckpt_1")
    reads.clear()
    with pytest.raises(CheckpointMismatch):
        mgr.restore_latest({"w": torch.zeros(7)})
    assert reads == []


def test_cheap_validation_npz_truncated(tmp_path):
    path = str(tmp_path / "ckpt_1.npz")
    save_state(path, {"w": torch.arange(4096.0)}, 1)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 3)
    with pytest.raises(CheckpointInvalid):
        tck.cheap_validate(path)


def test_sync_sharded_save_memory_is_one_shard(tmp_path):
    """The save's peak host materialization is one shard (here the largest
    leaf), not the state."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"big": torch.ones(8, 4096), "small": torch.ones(4096)}, 1)
    stats = mgr.last_save_stats
    assert stats.bytes == 9 * 4096 * 4 and stats.shards == 2
    assert stats.peak_pending_bytes == 8 * 4096 * 4


def test_resave_same_step_swaps_safely(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"w": _w(4, fill=1.0)}, step_id=2)
    mgr.save({"w": _w(4, fill=9.0)}, step_id=2)
    state, step_id = mgr.restore_latest({"w": torch.zeros(4)})
    assert step_id == 2
    np.testing.assert_array_equal(state["w"].numpy(), np.full((4,), 9.0))
    assert sorted(os.listdir(tmp_path)) == ["ckpt_2"]


def test_manager_init_reclaims_stranded_work_dirs(tmp_path):
    (tmp_path / ".tmp_ckpt_3_x").mkdir()
    (tmp_path / ".old_ckpt_3_y").mkdir()
    CheckpointManager(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == []


def test_load_arrays_vanished_shard_is_checkpoint_invalid(tmp_path):
    path = CheckpointManager(str(tmp_path)).save({"w": torch.arange(8.0)}, 1)
    shard = next(os.path.join(path, f) for f in sorted(os.listdir(path)) if f.endswith(".bin"))
    os.unlink(shard)
    with pytest.raises(CheckpointInvalid, match="unreadable|missing"):
        load_arrays(path)


# ---------------------------------------------------------------------------
# The two packages against each other.
# ---------------------------------------------------------------------------

FLAG_SETS = [
    [],
    ["--model", "amoebanet", "--image-size", "1024", "--num-layers", "18",
     "--num-filters", "416", "--num-classes", "1000", "--batch-size", "1",
     "--precision", "bf_16", "--pallas-conv", "--no-remat", "--app", "1",
     "--datapath", "/data/x", "--num-workers", "2", "--checkpoint-dir", "/ck"],
    ["--num-spatial-parts", "4,2", "--spatial-size", "2", "--split-size", "3",
     "--halo-d2", "--spatial-until", "auto", "--slice-method", "vertical",
     "--precision", "bf_16_all", "--local-DP", "2", "--balance", "4,4,3"],
    ["--split-size", "4", "--parts", "2", "--schedule", "1f1b", "--times", "2",
     "--enable-gems", "--data-parallel", "2", "--lr", "0.01", "--no-pallas-conv",
     "--stripe-bwd", "--per-tile-bn", "--seed", "7"],
]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=range(len(FLAG_SETS)))
def test_fingerprints_equal_jax(flags):
    from mpi4dl_tpu.config import config_from_args as jcfg_from
    from mpi4dl_tpu.config import get_parser as jparser
    from mpi4dl_tpu.mesh import MeshSpec as JSpec
    from mpi4dl_tpu_torch.config import config_from_args, get_parser
    from mpi4dl_tpu_torch.mesh import MeshSpec

    jc, tc = jcfg_from(jparser().parse_args(flags)), config_from_args(get_parser().parse_args(flags))
    js, ts = JSpec.from_config(jc), MeshSpec.from_config(tc)
    extra_i = {"steps_per_epoch": 4}
    extra_l = {"quant_resolved": "off", "stripe_bwd_resolved": "0"}
    assert config_fingerprint(tc, ts, extra_i) == jck.config_fingerprint(jc, js, extra_i)
    assert (split_config_fingerprint(tc, ts, extra_i, extra_l)
            == jck.split_config_fingerprint(jc, js, extra_i, extra_l))


def _jax_model(kind):
    from mpi4dl_tpu.models.amoebanet import amoebanetd
    from mpi4dl_tpu.models.resnet import get_resnet_v2

    if kind == "amoebanet":
        return amoebanetd((2, 32, 32, 3), num_classes=10, num_layers=3, num_filters=16)
    return get_resnet_v2((2, 32, 32, 3), depth=11, num_classes=10)


def _torch_model(kind, dtype):
    from mpi4dl_tpu_torch.models import amoebanetd

    if kind == "amoebanet":
        return amoebanetd((2, 32, 32, 3), num_classes=10, num_layers=3, num_filters=16,
                          device="cpu", seed=3, dtype=dtype)
    return _resnet(seed=3, dtype=dtype)


def _jax_state(kind, opt_kind, momentum, bf16):
    """A JAX TrainState with random parameters and a random optimizer
    state, zero where the JAX optimizer keeps zeros (the slots of running
    statistics, which get no gradient)."""
    from mpi4dl_tpu.train import Optimizer as JOpt, TrainState as JTS

    params, _ = _jax_model(kind).init(jax.random.key(0))
    if bf16:
        params = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
    opt = JOpt(opt_kind, lr=0.01, momentum=momentum)
    state = JTS.create(params, opt)
    rng = np.random.default_rng(1)

    def fill(path, leaf):
        if getattr(path[-1], "key", None) in ("mean", "var"):
            return leaf
        return jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32))

    slots = [jax.tree_util.tree_map_with_path(fill, s) for s in state.opt_state[:2]]
    opt_state = tuple(slots) + ((jnp.asarray(3, jnp.int32),) if opt_kind == "adam" else ())
    return JTS(params, opt_state, jnp.asarray(5, jnp.int32)), opt


OPTS = [("sgd", 0.0), ("sgd", 0.9), ("adam", 0.0)]
CROSS = [(kind, o, m, fmt, False) for kind in ("amoebanet", "resnet") for o, m in OPTS
         for fmt in ("sharded", "npz")] + [
    ("amoebanet", "adam", 0.0, "sharded", True), ("resnet", "sgd", 0.9, "sharded", True)]


@pytest.mark.parametrize("kind,opt_kind,momentum,fmt,bf16", CROSS)
def test_cross_package_restore_both_ways(tmp_path, kind, opt_kind, momentum, fmt, bf16):
    """JAX saves; the port restores parameters bitwise equal to
    ``params.from_jax_params`` of the same arrays (and the optimizer state
    and step); the port saves; JAX restores every leaf bitwise."""
    from mpi4dl_tpu.train import TrainState as JTS

    jstate, jopt = _jax_state(kind, opt_kind, momentum, bf16)
    jck.CheckpointManager(str(tmp_path / "j"), format=fmt).save(jstate, 5)

    dtype = torch.bfloat16 if bf16 else torch.float32
    topt = Optimizer(opt_kind, lr=0.01, momentum=momentum)
    model = _torch_model(kind, dtype)
    state, sid = CheckpointManager(str(tmp_path / "j"), format=fmt).restore_latest(
        TrainState.create(model, topt))
    assert sid == 5 and state.step == 5
    want = _torch_model(kind, dtype)
    tparams.from_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float32), jstate.params),
                            want)
    for a, b in zip(tparams.layout_tensors(model), tparams.layout_tensors(want)):
        for x, y in zip(tck._tree_tensors(a), tck._tree_tensors(b)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    jleaves = jax.tree.leaves(jstate)
    tleaves = tck.state_leaves(state)
    assert len(tleaves) == len(jleaves)
    for j, t in zip(jleaves, tleaves):
        got = t.full()
        assert tck.dtype_name(got.dtype) == str(np.asarray(j).dtype)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(j, np.float32))
    if opt_kind == "adam":
        assert state.opt_state[2] == 3

    CheckpointManager(str(tmp_path / "t"), format=fmt).save(state, 6)
    template = JTS(jax.tree.map(jnp.zeros_like, jstate.params),
                   jax.tree.map(jnp.zeros_like, jstate.opt_state), jnp.zeros((), jnp.int32))
    back, sid = jck.CheckpointManager(str(tmp_path / "t"), format=fmt).restore_latest(template)
    assert sid == 6
    for a, b in zip(jax.tree.leaves(back), jleaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cross_package_trained_state(tmp_path):
    """After a real JAX training step (momentum SGD) the optimizer slots of
    the running statistics are zeros, so the port's checkpoint of the
    restored state is the JAX checkpoint, byte for byte."""
    from mpi4dl_tpu.train import Optimizer as JOpt, TrainState as JTS
    from mpi4dl_tpu.train import make_train_step as jstep

    jm = _jax_model("resnet")
    params, _ = jm.init(jax.random.key(0))
    opt = JOpt("sgd", lr=0.01, momentum=0.9)
    x = jax.random.normal(jax.random.key(1), (2, 32, 32, 3))
    jstate, _ = jstep(jm, opt)(JTS.create(params, opt), x, jnp.array([0, 1], jnp.int32))
    jpath = jck.CheckpointManager(str(tmp_path / "j")).save(jstate, 1)
    state, _ = CheckpointManager(str(tmp_path / "j")).restore_latest(
        TrainState.create(_torch_model("resnet", torch.float32),
                          Optimizer("sgd", lr=0.01, momentum=0.9)))
    tpath = CheckpointManager(str(tmp_path / "t")).save(state, 1)
    jm_, tm_ = (json.load(open(os.path.join(p, tck.SHARD_MANIFEST))) for p in (jpath, tpath))
    assert [l["shards"][0]["crc32"] for l in tm_["leaves"]] == \
        [l["shards"][0]["crc32"] for l in jm_["leaves"]]
    assert [(l["shape"], l["dtype"]) for l in tm_["leaves"]] == \
        [(l["shape"], l["dtype"]) for l in jm_["leaves"]]


# ---------------------------------------------------------------------------
# The committed JAX checkpoint that the card-only tests restore onto a CUDA
# model (tests/test_torch_cuda.py; the card's machine has no JAX).
# ---------------------------------------------------------------------------

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "jax_checkpoint")


def _fixture_state():
    """A small conv-BN-dense model's JAX TrainState: the structure of its
    ``init``, every value from numpy seed 3 (parameters, running
    statistics, momentum slots; zero slots for the running statistics),
    step 1 — numpy draws only, so the bytes do not depend on the host."""
    from mpi4dl_tpu import cells as jc, layers as jl
    from mpi4dl_tpu.train import TrainState as JTS

    model = jc.CellModel([
        jc.LayerCell([jl.Conv2d(3, 8, 3, bias=False), jl.BatchNorm(8), jl.ReLU()]),
        jc.LayerCell([jl.GlobalAvgPool(), jl.Dense(8, 5)]),
    ], (4, 8, 8, 3), 5)
    shapes, _ = model.init(jax.random.key(2))
    rng = np.random.default_rng(3)

    def draw(leaf):
        return jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32))

    def slot(path, leaf):
        if getattr(path[-1], "key", None) in ("mean", "var"):
            return jnp.zeros(leaf.shape, jnp.float32)
        return draw(leaf)

    params = jax.tree.map(draw, shapes)
    return JTS(params, (jax.tree_util.tree_map_with_path(slot, params),),
               jnp.asarray(1, jnp.int32))


def test_committed_jax_checkpoint_is_the_jax_packages(tmp_path):
    """tests/data/jax_checkpoint/ckpt_1 is what the JAX package writes for
    :func:`_fixture_state`, byte for byte, and the port restores it."""
    path = jck.CheckpointManager(str(tmp_path)).save(_fixture_state(), 1)
    want = os.path.join(FIXTURE, "ckpt_1")
    assert sorted(os.listdir(path)) == sorted(os.listdir(want))
    for f in os.listdir(path):
        with open(os.path.join(path, f), "rb") as a, open(os.path.join(want, f), "rb") as b:
            assert a.read() == b.read(), f
    from mpi4dl_tpu_torch import cells as tc, layers as tl

    model = tc.CellModel([
        tc.LayerCell([tl.Conv2d(3, 8, 3, bias=False), tl.BatchNorm(8), tl.ReLU()]),
        tc.LayerCell([tl.GlobalAvgPool(), tl.Dense(8, 5)]),
    ], (4, 8, 8, 3), 5)
    state, sid = CheckpointManager(FIXTURE).restore_latest(
        TrainState.create(model, Optimizer("sgd", lr=0.05, momentum=0.9)))
    assert sid == 1 and state.step == 1
    for j, t in zip(jax.tree.leaves(_fixture_state()), tck.state_leaves(state)):
        np.testing.assert_array_equal(t.full().numpy(), np.asarray(j))
