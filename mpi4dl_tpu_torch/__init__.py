"""mpi4dl_tpu_torch — the PyTorch / CUDA (H100) port of ``mpi4dl_tpu``.

Slices so far: single-device AmoebaNet-D training, with the JAX package's
two main-path Pallas kernels (the margin-consuming conv K1 and the fused
relu→conv→BN-stats K2) as hand-written CUDA kernels for ``sm_90a``
(``ops/halo_conv.py``, ``csrc/halo_conv.cu``); and the long-context family
— the ``SeqBlock`` transformer block, exact ring attention over a
sequence-sharded process group and the context-parallel SGD step — with
the block-flash kernel K3 (``ops/flash_attention.py``,
``csrc/block_flash.cu``); and spatial-parallel training of AmoebaNet-D and
ResNet, D1 (a halo exchange per conv or pool) and D2 (one accumulated halo
per fused run), on one tile per rank or on a one-process tile grid
(``parallel/``, ``ops/halo.py``, ``ops/d2.py``), with K1 and K2 on tiles
that carry their halo margins.  The package imports neither JAX nor
``mpi4dl_tpu``.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
from mpi4dl_tpu_torch.models import (
    SeqBlock, amoebanetd, build_model, get_resnet, make_seq_cp_train_step,
)
from mpi4dl_tpu_torch.train import (
    Optimizer, TrainState, make_eval_step, make_spatial_eval_step,
    make_spatial_train_step, make_train_step,
)

__all__ = [
    "ApplyCtx", "SpatialCtx", "SeqBlock", "amoebanetd", "build_model", "get_resnet",
    "Optimizer", "TrainState", "make_eval_step", "make_seq_cp_train_step",
    "make_spatial_eval_step", "make_spatial_train_step", "make_train_step",
]
