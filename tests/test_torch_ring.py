"""Ring attention and the context-parallel train step of the PyTorch port
(mpi4dl_tpu_torch/ops/ring.py, models/seqblock.py) on four gloo ranks,
against the JAX package on one device.

Each check that needs ranks spawns four processes that run this file as a
script (``python tests/test_torch_ring.py <job> <rank> <world> <dir>``):
they meet through a ``file://`` store in a fresh temporary directory,
give ``init_process_group`` a 60 s timeout, read their inputs from and
write their results to that directory, and are killed if they outlive
``RANK_DEADLINE_S``.  The file spawns three times (ring attention, the
train step, the 1-D ghost exchange and conv), a few seconds each.  JAX is imported inside the tests only, so the
ranks never load it.

Tolerances are the JAX tests': ring values rtol/atol 2e-5
(test_pallas_attention.py:157-176), ring grads rtol 1e-4 / atol 1e-5
(:179-208), train-step losses rtol 1e-5 and params rtol 1e-4 / atol 1e-6
(test_seqblock.py:48-79).
"""

import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
RANK_DEADLINE_S = 180
SHAPE = (2, 32, 2, 8)          # ring inputs [B, T, H, D], T split over WORLD
PATHS = ("einsum", "flash")
CP_LR = 0.05
CP_STEPS = 3
GHOST_KS = (3, 5)


def launch_gloo_ranks(job: str, workdir: Path, world: int = WORLD,
                      script: str = __file__) -> None:
    """Run ``job`` on ``world`` gloo ranks (processes running ``script``,
    this file by default); fail on a non-zero exit or on ranks still
    running after ``RANK_DEADLINE_S``."""
    path = os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        log = open(workdir / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, script, job, str(rank), str(world), str(workdir)],
            env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_DEADLINE_S
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{job}: ranks still running after {RANK_DEADLINE_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(
        f"rank {r} exit {procs[r].returncode}:\n"
        + (workdir / f"rank{r}.log").read_text()[-3000:] for r in bad)


def _gather(workdir: Path, world: int = WORLD):
    """Per key, the ranks' arrays concatenated along the sequence axis."""
    outs = [np.load(workdir / f"out{r}.npz") for r in range(world)]
    return {key: np.concatenate([o[key] for o in outs], axis=1) for key in outs[0].files}


# ---------------------------------------------------------------------------
# Rank side (runs in the spawned processes; no JAX).
# ---------------------------------------------------------------------------


def _init(rank: int, world: int, workdir: Path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{workdir / 'rendezvous'}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=60))
    return dist.group.WORLD


def _shard(x: np.ndarray, rank: int, world: int) -> torch.Tensor:
    t = x.shape[1] // world
    return torch.from_numpy(np.ascontiguousarray(x[:, rank * t:(rank + 1) * t]))


def _rank_ring(rank: int, world: int, workdir: Path) -> dict:
    from mpi4dl_tpu_torch.ops.ring import ring_attention

    group = _init(rank, world, workdir)
    inp = np.load(workdir / "inputs.npz")
    qs, ks, vs = (_shard(inp[key], rank, world) for key in ("q", "k", "v"))
    out = {}
    for path in PATHS:
        flash = path == "flash"
        for causal in (False, True):
            with torch.no_grad():
                o = ring_attention(qs, ks, vs, group, world, causal=causal, use_flash=flash)
            out[f"{path}_causal{int(causal)}"] = o.numpy()
        ts = [x.clone().requires_grad_() for x in (qs, ks, vs)]
        o = ring_attention(*ts, group, world, causal=True, use_flash=flash)
        ((o * o).mean() / world).backward()
        for name, t in zip("qkv", ts):
            out[f"{path}_d{name}"] = t.grad.numpy()
    return out


def _rank_cp_step(rank: int, world: int, workdir: Path) -> dict:
    from mpi4dl_tpu_torch import params as tparams
    from mpi4dl_tpu_torch.models.seqblock import SeqBlock, make_seq_cp_train_step

    group = _init(rank, world, workdir)
    inp = np.load(workdir / "inputs.npz")
    n_blocks = int(inp["n_blocks"])
    x, y = _shard(inp["x"], rank, world), _shard(inp["y"], rank, world)
    out = {}
    for path in PATHS:
        blocks = torch.nn.ModuleList(SeqBlock(16, 2, device="cpu") for _ in range(n_blocks))
        tparams.from_jax_params(
            [{k[len(f"b{i}_"):]: inp[k] for k in inp.files if k.startswith(f"b{i}_")}
             for i in range(n_blocks)], blocks)
        step = make_seq_cp_train_step(blocks, group, world, CP_LR,
                                      use_flash=path == "flash", device="cpu")
        losses = [float(step(x, y)) for _ in range(CP_STEPS)]
        # Leading axes of length 1 so _gather's concatenation keeps rank 0's.
        out[f"{path}_losses"] = np.asarray(losses)[None, None]
        for i, p in enumerate(tparams.to_jax_layout(blocks)):
            for key, val in p.items():
                out[f"{path}_b{i}_{key}"] = val[None, None]
    return out


def _rank_ghost(rank: int, world: int, workdir: Path) -> dict:
    from mpi4dl_tpu_torch.ops.ring import ghost_conv1d, seq_ghost_exchange

    group = _init(rank, world, workdir)
    inp = np.load(workdir / "inputs.npz")
    out = {"exchange": seq_ghost_exchange(_shard(inp["seq"], rank, world), group, world,
                                          2, 1).numpy()}
    x = _shard(inp["x"], rank, world)
    for k in GHOST_KS:
        out[f"conv{k}"] = ghost_conv1d(x, torch.from_numpy(inp[f"kernel{k}"]), group,
                                       world).numpy()
    return out


def _rank_main(job: str, rank: int, world: int, workdir: Path) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = {"ring": _rank_ring, "cp_step": _rank_cp_step,
           "ghost": _rank_ghost}[job](rank, world, workdir)
    dist.barrier()
    dist.destroy_process_group()
    np.savez(workdir / f"out{rank}.npz", **out)


# ---------------------------------------------------------------------------
# Test side.
# ---------------------------------------------------------------------------


def _qkv(shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("ring")
    q, k, v = _qkv()
    np.savez(workdir / "inputs.npz", q=q, k=k, v=v)
    launch_gloo_ranks("ring", workdir)
    return (q, k, v), _gather(workdir)


@pytest.fixture(scope="module")
def cp_run(tmp_path_factory):
    import jax

    from mpi4dl_tpu.models import seqblock as jsb

    workdir = tmp_path_factory.mktemp("cp_step")
    blocks = [jsb.SeqBlock(16, 2), jsb.SeqBlock(16, 2)]
    params = [jax.tree.map(np.asarray, b.init(jax.random.key(i)))
              for i, b in enumerate(blocks)]
    rng = np.random.default_rng(3)
    x, y = (rng.standard_normal((2, 32, 16)).astype(np.float32) for _ in range(2))
    flat = {f"b{i}_{key}": val for i, p in enumerate(params) for key, val in p.items()}
    np.savez(workdir / "inputs.npz", x=x, y=y, n_blocks=len(blocks), **flat)
    launch_gloo_ranks("cp_step", workdir)
    return blocks, params, x, y, _gather(workdir)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("path", PATHS)
def test_ring_attention_matches_jax(ring_run, path, causal):
    import jax.numpy as jnp

    from mpi4dl_tpu.ops.ring import ring_attention

    (q, k, v), got = ring_run
    want = ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 1,
                          causal=causal, use_flash=False)
    np.testing.assert_allclose(got[f"{path}_causal{int(causal)}"], np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("path", PATHS)
def test_ring_grads_match_jax(ring_run, path):
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.ops.ring import ring_attention

    (q, k, v), got = ring_run

    def loss(q, k, v):
        o = ring_attention(q, k, v, None, 1, causal=True, use_flash=False)
        return jnp.mean(o * o)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, w in zip("qkv", want):
        np.testing.assert_allclose(got[f"{path}_d{name}"], np.asarray(w),
                                   rtol=1e-4, atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("path", PATHS)
def test_cp_train_step_matches_jax_single_device_sgd(cp_run, path):
    import jax
    import jax.numpy as jnp

    blocks, params, x, y, got = cp_run

    def ref_loss(params_list, x, y):
        h = x
        for blk, p in zip(blocks, params_list):
            h = blk.apply(p, h)
        err = (h - y).astype(jnp.float32)
        return jnp.mean(err * err)

    ref = jax.tree.map(jnp.asarray, params)
    losses_ref = []
    for _ in range(CP_STEPS):
        loss, grads = jax.value_and_grad(ref_loss)(ref, jnp.asarray(x), jnp.asarray(y))
        ref = jax.tree.map(lambda p, g: p - CP_LR * g, ref, grads)
        losses_ref.append(float(loss))
    # Every rank reports the same global loss and ends with the same params.
    losses = got[f"{path}_losses"][0]
    assert np.all(losses == losses[0])
    np.testing.assert_allclose(losses[0], losses_ref, rtol=1e-5)
    for i, p in enumerate(ref):
        for key, want in p.items():
            ranks = got[f"{path}_b{i}_{key}"][0]
            assert np.all(ranks == ranks[0]), key
            np.testing.assert_allclose(ranks[0], np.asarray(want), rtol=1e-4, atol=1e-6,
                                       err_msg=f"block {i} {key}")
    assert losses[0][-1] < losses[0][0]


@pytest.fixture(scope="module")
def ghost_run(tmp_path_factory):
    import jax

    workdir = tmp_path_factory.mktemp("ghost")
    seq = np.arange(2 * 16 * 3, dtype=np.float32).reshape(2, 16, 3)
    x = np.asarray(jax.random.normal(jax.random.key(0), (2, 16, 8)))
    kernels = {f"kernel{k}": np.asarray(jax.random.normal(jax.random.key(1), (k, 8, 16)) * 0.1)
               for k in GHOST_KS}
    np.savez(workdir / "inputs.npz", seq=seq, x=x, **kernels)
    launch_gloo_ranks("ghost", workdir)
    outs = [np.load(workdir / f"out{r}.npz") for r in range(WORLD)]
    return seq, x, kernels, outs


def test_seq_ghost_exchange_matches_pad(ghost_run):
    """Each rank's ghost-extended shard equals the window of the
    zero-padded sequence (tests/test_ring.py:20-40)."""
    seq, _, _, outs = ghost_run
    padded = np.pad(seq, ((0, 0), (2, 1), (0, 0)))
    shard = seq.shape[1] // WORLD
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o["exchange"], padded[:, i * shard:i * shard + shard + 3])


@pytest.mark.parametrize("k", GHOST_KS)
def test_ghost_conv1d_matches_single_device(ghost_run, k):
    """The sharded ghost conv, gathered, against the JAX package's unsharded
    ``ghost_conv1d`` (tests/test_ring.py:43-58, rtol/atol 1e-5)."""
    import jax.numpy as jnp

    from mpi4dl_tpu.ops.ring import ghost_conv1d as jax_ghost_conv1d
    from mpi4dl_tpu_torch.ops.ring import ghost_conv1d

    _, x, kernels, outs = ghost_run
    want = np.asarray(jax_ghost_conv1d(jnp.asarray(x), jnp.asarray(kernels[f"kernel{k}"]),
                                       None, 1))
    got = np.concatenate([o[f"conv{k}"] for o in outs], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = ghost_conv1d(torch.from_numpy(x), torch.from_numpy(kernels[f"kernel{k}"]), None, 1)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_emulated_ring_matches_plain_attention(causal):
    """The one-process ring schedule through block_flash with per-hop
    offsets (the chip's ring phase) against plain attention
    (tests/flash_ring_check.py:82-93)."""
    import jax.numpy as jnp
    from flash_ring_check import reference

    from mpi4dl_tpu_torch.ops.ring import emulated_ring

    q, k, v = _qkv((1, 64, 2, 16))
    want = reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    got = emulated_ring(*(torch.from_numpy(a) for a in (q, k, v)), 4, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_ring_refuses_a_wrong_rank_count():
    from mpi4dl_tpu_torch.ops.ring import ring_attention

    q = torch.zeros((1, 8, 1, 4))
    with pytest.raises(ValueError, match="n=2 but the group has 1 ranks"):
        ring_attention(q, q, q, None, 2)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
