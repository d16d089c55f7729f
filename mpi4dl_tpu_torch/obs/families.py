"""The engine families' contract-sized steps (counterpart of
``mpi4dl_tpu/analysis/contracts/engines.py``'s frozen builds): ResNet v2
depth 11, 32², batch 4 (8 for ``gems_sp``), 2 stages, 2 micro-batches, the
spatial families on 2 vertical tiles; ``<family>_1f1b`` runs 1F1B.

:func:`family_role` runs rank 0's step of a family on the ``fake`` process
group with the instruments on (``benchmarks/mem_probe.probe_role``): its
recorded collectives, its FLOPs by scope, the breakdown of its peak, its
timeline and its CPU ledger.  ``obs overlap --families`` and ``obs trace
--families`` read them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

ENGINE_FAMILIES: Tuple[str, ...] = (
    "lp", "sp", "gems", "gems_sp",
    "lp_1f1b", "sp_1f1b", "gems_1f1b", "gems_sp_1f1b",
)
STAGES = 2
PARTS = 2


def family_flags(family: str) -> Tuple[str, List[str]]:
    """(the runner family, its flags) of a contract family."""
    if family not in ENGINE_FAMILIES:
        raise ValueError(f"unknown engine family {family!r}; have {ENGINE_FAMILIES}")
    schedule = "1f1b" if family.endswith("_1f1b") else "gpipe"
    base = family[: -len("_1f1b")] if family.endswith("_1f1b") else family
    batch = 8 if base == "gems_sp" else 4
    flags = ["--model", "resnet", "--image-size", "32", "--num-layers", "11",
             "--batch-size", str(batch), "--split-size", str(STAGES),
             "--parts", str(PARTS), "--schedule", schedule]
    if base in ("gems", "gems_sp"):
        flags += ["--times", "1"]
    if base in ("sp", "gems_sp"):
        flags += ["--num-spatial-parts", "2", "--slice-method", "vertical"]
    return base, flags


def family_role(family: str, rank: int = 0) -> Dict[str, Any]:
    """Rank ``rank``'s instrumented step of ``family`` on the fake group."""
    from mpi4dl_tpu_torch.benchmarks.mem_probe import probe_role
    from mpi4dl_tpu_torch.config import config_from_args, get_parser

    base, flags = family_flags(family)
    cfg = config_from_args(get_parser().parse_args(flags))
    return probe_role(cfg, base, rank, instruments=True)


def schedule_of(family: str) -> str:
    return "1f1b" if family.endswith("_1f1b") else "gpipe"
