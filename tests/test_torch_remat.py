"""The remat levels of the PyTorch port's single-device step
(``make_train_step(remat=...)``: "cell", "sqrt", "fine", and
``MPI4DL_REMAT_OPS=1`` under "sqrt") against the JAX package's
``make_train_step(remat=...)`` on the CPU, and against the port's own
step without remat: two SGD steps give the same losses (rtol 1e-4) and
parameters and running statistics (rtol 2e-3 / atol 1e-5) — recompute
does not apply a BatchNorm's running-statistics update twice.  Both sides
run in float64 (``jax.enable_x64``), as ``test_torch_pipeline.py`` runs
its JAX reference: in fp32 a 2-image BatchNorm'd step of these models
already moves its parameters by more than that between summation orders.  The saved
tensors of one forward (``torch.autograd.graph.saved_tensors_hooks``)
fall from no remat to cell to sqrt at a depth where they should.
"""

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch.models import amoebanetd, get_resnet_v2
from mpi4dl_tpu_torch.params import from_jax_params, to_jax_layout
from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

TOL = dict(rtol=2e-3, atol=1e-5)


def _models(arch, batch, dtype=torch.float64):
    import jax

    from mpi4dl_tpu.models.amoebanet import amoebanetd as j_amoebanetd
    from mpi4dl_tpu.models.resnet import get_resnet_v2 as j_resnet_v2

    shape = (batch, 32, 32, 3)
    if arch == "resnet":
        jm = j_resnet_v2(shape, depth=20, num_classes=10)
        tm = get_resnet_v2(shape, 20, 10, device="cpu", dtype=dtype)
    else:
        jm = j_amoebanetd(shape, num_classes=10, num_layers=3, num_filters=16)
        tm = amoebanetd(shape, num_classes=10, num_layers=3, num_filters=16, device="cpu",
                        dtype=dtype)
    params, _ = jm.init(jax.random.key(0))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    from_jax_params(params, tm)
    return jm, params, tm


@pytest.mark.parametrize("arch,remat,ops", [
    ("resnet", "sqrt", None), ("resnet", "fine", None), ("resnet", "sqrt", "1"),
    ("amoebanet", "sqrt", None), ("amoebanet", "fine", None), ("resnet", "cell", None),
])
def test_remat_level_matches_jax_and_no_remat(monkeypatch, arch, remat, ops):
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.train import (
        Optimizer as JOptimizer, TrainState as JTrainState, make_train_step as j_step,
    )

    if ops is None:
        monkeypatch.delenv("MPI4DL_REMAT_OPS", raising=False)
    else:
        monkeypatch.setenv("MPI4DL_REMAT_OPS", ops)
    monkeypatch.setenv("MPI4DL_SQRT_GROUPS", "0")
    batch = 2
    jm, params, tm = _models(arch, batch)
    _, _, plain = _models(arch, batch)
    x = np.random.default_rng(1).standard_normal((batch, 32, 32, 3))
    y = np.arange(batch) % 10
    jopt, opt = JOptimizer("sgd", lr=0.01), Optimizer("sgd", lr=0.01)
    step, state = (make_train_step(tm, opt, remat=remat, compute_dtype=torch.float64),
                   TrainState.create(tm, opt))
    pstep, pstate = (make_train_step(plain, opt, compute_dtype=torch.float64),
                     TrainState.create(plain, opt))
    with jax.enable_x64(True):
        jstep = j_step(jm, jopt, remat=True if remat == "cell" else remat,
                       compute_dtype=jnp.float64)
        jstate = JTrainState.create(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                                 params), jopt)
        for _ in range(2):
            jstate, jm_ = jstep(jstate, jnp.asarray(x), jnp.asarray(y, jnp.int32))
            state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
            pstate, pm = pstep(pstate, torch.from_numpy(x), torch.from_numpy(y))
            np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]), rtol=1e-4)
            np.testing.assert_allclose(float(m["loss"]), float(pm["loss"]), rtol=1e-4)
        want = jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))
    for a, b, c in zip(jax.tree.leaves(to_jax_layout(tm)), want,
                       jax.tree.leaves(to_jax_layout(plain))):
        np.testing.assert_allclose(a, b, **TOL)
        np.testing.assert_allclose(a, c, **TOL)


def _saved_bytes(model, remat, x, y):
    """Bytes of the tensors autograd saves for the backward during one
    forward of the loss (those held after the forward, recompute aside)."""
    from mpi4dl_tpu_torch.layer_ctx import ApplyCtx
    from mpi4dl_tpu_torch.train import cross_entropy

    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits = model(x, ApplyCtx(train=True, bn_sink={}),
                       remat="sqrt" if remat == "sqrt" else bool(remat))
        cross_entropy(logits, y)
    return total[0]


def test_sqrt_saves_less_than_cell_at_depth():
    """ResNet-56 v2 (20 cells): the outer checkpoints of ~√n groups save
    fewer bytes than one checkpoint a cell, which save fewer than no
    remat."""
    m = get_resnet_v2((2, 32, 32, 3), 56, 10, device="cpu")
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([1, 2])
    b = {r: _saved_bytes(m, r, x, y) for r in (False, "cell", "sqrt")}
    assert b["sqrt"] < b["cell"] < b[False], b
