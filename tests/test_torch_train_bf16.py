"""One bf16 training step of the port's AmoebaNet-D against the JAX
package's fused (``pallas_conv``) loss at bf16 compute.

Same model, weights and inputs as tests/test_torch_train.py (fp32 params,
bf16 compute, 128x128).  bf16 keeps 8 significant bits and the frameworks
round at different places, so the step is held at a bf16 bound: the loss
within rtol 2e-2, and the logits no further from the fp32 logits than twice
the JAX package's own bf16 logits are (its bf16 runs sit 0.036-0.063 apart
from each other and from fp32, on logits of magnitude 0.32, at this
config).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpi4dl_tpu.layer_ctx import ApplyCtx as JApplyCtx, SpatialCtx as JSpatialCtx
from mpi4dl_tpu.models.amoebanet import amoebanetd as j_amoebanetd
from mpi4dl_tpu.train import make_loss_fn as j_make_loss_fn
from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
from mpi4dl_tpu_torch.params import from_jax_params
from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

SHAPE = (2, 128, 128, 3)
ARGS = dict(num_classes=10, num_layers=3, num_filters=16)


def test_bf16_step_matches_jax():
    jmodel = j_amoebanetd(SHAPE, **ARGS)
    params, _ = jmodel.init(jax.random.key(0))
    rng = np.random.default_rng(1)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    y = np.arange(2, dtype=np.int32)
    fused = JApplyCtx(train=True, spatial=JSpatialCtx(use_pallas_conv=True))
    j_loss, (j_logits, _) = jax.jit(j_make_loss_fn(jmodel, fused))(
        params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(y))
    _, (f32_logits, _) = jax.jit(j_make_loss_fn(jmodel, JApplyCtx(train=True)))(
        params, jnp.asarray(x), jnp.asarray(y))

    model = amoebanetd(SHAPE, device="cpu", **ARGS)
    from_jax_params(jax.tree.map(np.asarray, params), model)
    opt = Optimizer("sgd", lr=0.01)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16, pallas_conv=True)
    logits = []
    model.cells[-1].register_forward_hook(lambda mod, inp, out: logits.append(out))
    _, m = step(TrainState.create(model, opt), torch.from_numpy(x), torch.from_numpy(y))

    assert logits[0].dtype == torch.bfloat16
    np.testing.assert_allclose(float(m["loss"]), float(j_loss), rtol=2e-2)
    ref = np.asarray(f32_logits)
    err_port = np.max(np.abs(logits[0].detach().float().numpy() - ref))
    err_jax = np.max(np.abs(np.asarray(j_logits, np.float32) - ref))
    assert err_port <= 2 * err_jax, (err_port, err_jax)
