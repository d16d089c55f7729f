"""mpi4dl_tpu_torch — the PyTorch / CUDA (H100) port of ``mpi4dl_tpu``.

This slice: single-device AmoebaNet-D training, with the JAX package's two
main-path Pallas kernels (the margin-consuming conv K1 and the fused
relu→conv→BN-stats K2) as hand-written CUDA kernels for ``sm_90a``
(``ops/halo_conv.py``, ``csrc/halo_conv.cu``).  The package imports
neither JAX nor ``mpi4dl_tpu``.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
from mpi4dl_tpu_torch.models import amoebanetd, build_model
from mpi4dl_tpu_torch.train import (
    Optimizer, TrainState, make_eval_step, make_train_step,
)

__all__ = [
    "ApplyCtx", "SpatialCtx", "amoebanetd", "build_model", "Optimizer",
    "TrainState", "make_eval_step", "make_train_step",
]
