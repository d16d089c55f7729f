"""The rule table: each rule lives in its own module and exports ``RULE``,
in the JAX analyzer's order (``mpi4dl_tpu/analysis/rules.py``)."""

from __future__ import annotations

from typing import Dict, List

from mpi4dl_tpu_torch.analysis.core import Rule
from mpi4dl_tpu_torch.analysis.rules_collective import RULE as _collective
from mpi4dl_tpu_torch.analysis.rules_dtype import RULE as _dtype
from mpi4dl_tpu_torch.analysis.rules_env import RULE as _env
from mpi4dl_tpu_torch.analysis.rules_pallas import RULE as _kernel
from mpi4dl_tpu_torch.analysis.rules_print import RULE as _print
from mpi4dl_tpu_torch.analysis.rules_quant import RULE as _quant
from mpi4dl_tpu_torch.analysis.rules_retrace import RULE as _import_time
from mpi4dl_tpu_torch.analysis.rules_scope import RULE as _scope
from mpi4dl_tpu_torch.analysis.rules_swallow import RULE as _swallow
from mpi4dl_tpu_torch.analysis.rules_thread import RULE as _thread
from mpi4dl_tpu_torch.analysis.rules_tracer import RULE as _host_sync

RULE_TABLE: List[Rule] = [
    _collective,
    _host_sync,
    _dtype,
    _env,
    _import_time,
    _print,
    _swallow,
    _thread,
    _scope,
    _quant,
    _kernel,
]

RULES_BY_NAME: Dict[str, Rule] = {r.name: r for r in RULE_TABLE}
