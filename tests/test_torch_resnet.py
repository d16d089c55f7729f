"""The port's ResNet v1 and v2 (mpi4dl_tpu_torch/models/resnet.py) against
the JAX package's on one device, with the K1 knob on (its stride-1 3x3
convs take the margin-consuming conv; on the CPU, its plain version).

As in ``tests/test_torch_train.py``, the JAX reference runs in float64
(``jax.enable_x64``) with the same parameters, so that the comparison is
about the port rather than about XLA's fp32 rounding; the tolerances are
that file's: logits rtol 1e-4 / atol 1e-6, loss rtol 1e-4, gradients and
post-step parameters rtol 2e-3 / atol 1e-5.  The JAX side's Pallas convs
run in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu.layer_ctx import ApplyCtx as JApplyCtx, SpatialCtx as JSpatialCtx
from mpi4dl_tpu.models.resnet import get_resnet as j_get_resnet
from mpi4dl_tpu.train import (
    Optimizer as JOptimizer, make_loss_fn as j_make_loss_fn,
    merge_stat_updates as j_merge_stat_updates,
)
from mpi4dl_tpu_torch.config import config_from_args, get_parser
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
from mpi4dl_tpu_torch.models import build_model, get_resnet
from mpi4dl_tpu_torch.ops import halo_conv
from mpi4dl_tpu_torch.params import from_jax_params, to_jax_layout
from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_loss_fn, make_train_step
from test_torch_spatial import count_pallas_calls

SHAPE = (2, 32, 32, 3)
LR = 0.01
VERSIONS = {1: 8, 2: 11}  # depth 6n+2 and 9n+2 at n = 1


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _inputs():
    rng = np.random.default_rng(1)
    return rng.standard_normal(SHAPE).astype(np.float32), np.array([3, 7], np.int32)


@pytest.fixture(scope="module", params=[1, 2], ids=["v1", "v2"])
def ref(request):
    """One JAX SGD step in float64 through jitted value_and_grad, and the
    number of Pallas calls in its traced step."""
    version = request.param
    model = j_get_resnet(SHAPE, VERSIONS[version], 10, version=version)
    params32, _ = model.init(jax.random.key(0))
    ctx = JApplyCtx(train=True, spatial=JSpatialCtx(use_pallas_conv=True))
    loss_fn = j_make_loss_fn(model, ctx, with_stats=True)
    x, y = _inputs()
    pallas = count_pallas_calls(jax.make_jaxpr(jax.value_and_grad(loss_fn, has_aux=True))(
        params32, jnp.asarray(x), jnp.asarray(y)).jaxpr)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params32)
        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (loss, (logits, stats)), grads = vg(params, jnp.asarray(x, jnp.float64), jnp.asarray(y))
        opt = JOptimizer("sgd", lr=LR)
        new, _ = opt.update(params, grads, opt.init(params))
        new = j_merge_stat_updates(new, stats)
        return dict(version=version, params=_np_tree(params32), grads=_np_tree(grads),
                    new=_np_tree(new), loss=float(loss),
                    logits=np.asarray(logits, np.float32), pallas=pallas)


def _port(ref, params):
    model = get_resnet(SHAPE, VERSIONS[ref["version"]], 10, version=ref["version"],
                       device="cpu")
    from_jax_params(params, model)
    return model


def _ctx():
    return ApplyCtx(train=True, spatial=SpatialCtx(use_pallas_conv=True))


def test_logits_and_loss_match_jax(ref):
    x, y = _inputs()
    loss, (logits, _) = make_loss_fn(_port(ref, ref["params"]), _ctx())(
        torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(logits.detach().numpy(), ref["logits"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-4)


def test_grads_match_jax(ref):
    model = _port(ref, ref["params"])
    x, y = _inputs()
    loss, _ = make_loss_fn(model, _ctx())(torch.from_numpy(x), torch.from_numpy(y))
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    want = _port(ref, ref["grads"])
    for name, g in want.named_parameters():
        np.testing.assert_allclose(grads[name].numpy(), g.detach().numpy(),
                                   rtol=2e-3, atol=1e-5, err_msg=name)


def test_sgd_step_matches_jax_and_dispatches_k1_as_jax_does(ref):
    model = _port(ref, ref["params"])
    opt = Optimizer("sgd", lr=LR)
    step = make_train_step(model, opt, pallas_conv=True)
    x, y = _inputs()
    with halo_conv.count_dispatches() as seen:
        _, m = step(TrainState.create(model, opt), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(m["loss"]), ref["loss"], rtol=1e-4)
    got = jax.tree.leaves(to_jax_layout(model))
    want = jax.tree.leaves(ref["new"])
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-5)
    assert seen.counts["halo_conv2d_stats"] == 0  # the convs carry a bias: no K2 window
    assert seen.counts == ref["pallas"] and seen.counts["halo_conv2d"] > 0


def test_softmax_in_model_and_build_model():
    """``--model resnet`` builds ResNet-(9n+2) v2; ``--softmax-in-model``
    ends it in a channel softmax."""
    cfg = config_from_args(get_parser().parse_args(
        ["--num-layers", "1", "--image-size", "32", "--batch-size", "2",
         "--softmax-in-model"]))
    model = build_model(cfg, device="cpu")
    assert model.name == "resnet11_v2"
    out = model(torch.from_numpy(_inputs()[0]), ApplyCtx(train=True))
    np.testing.assert_allclose(out.detach().sum(dim=-1).numpy(), 1.0, rtol=1e-6)
