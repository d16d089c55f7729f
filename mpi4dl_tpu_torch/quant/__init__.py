"""Quantized collectives (counterpart of ``mpi4dl_tpu/quant``; EQuARX,
arxiv 2506.17615).

The payload that crosses the wire at the four hot collective classes is
encoded per block (int8 / fp8 e4m3 / packed int4 with f32 block scales),
moved, and decoded on arrival:

- ``junction`` — the SP→LP junction's gather and ``batch_split``
  all_to_all, and SP x PP's stage lineup;
- ``respatial`` — multi-level SP's level transitions (the coarsening ring
  and the gather path; the refine slice moves nothing);
- ``grad`` — the gradient and running-statistics means over ranks, as an
  EQuARX two-shot (quantized all_to_all, exact f32 sums per shard,
  quantized all_gather);
- ``handoff`` — the pipeline's stage and cotangent handoffs.

Opt-in per class (``--quant``, ``ParallelConfig.quant_collectives``, the
``MPI4DL_QUANT_COLLECTIVES`` hatch; :class:`QuantPolicy`); off builds
today's engines bit for bit.  The gathers quantize their forward only:
their backward stays the exact adjoint.  The GEMS mirror (parameters),
the loss reduction, the in-cell BatchNorm sums and the halos are never
quantized.
"""

from mpi4dl_tpu_torch.quant.collectives import (
    RAW_BYTES,
    WIRE_BYTES,
    quantized_all_gather,
    quantized_all_to_all,
    quantized_pmean,
    quantized_pmean_tree,
    quantized_shift,
    reset_wire_bytes,
)
from mpi4dl_tpu_torch.quant.kernels import MODES, dequantize, quant_error_bound, quantize
from mpi4dl_tpu_torch.quant.policy import HOT_SCOPE_PATTERNS, QuantPolicy

__all__ = [
    "HOT_SCOPE_PATTERNS",
    "MODES",
    "QuantPolicy",
    "RAW_BYTES",
    "WIRE_BYTES",
    "dequantize",
    "quant_error_bound",
    "quantize",
    "quantized_all_gather",
    "quantized_all_to_all",
    "quantized_pmean",
    "quantized_pmean_tree",
    "quantized_shift",
    "reset_wire_bytes",
]
