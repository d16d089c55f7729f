"""Contract extraction: a family's recorded rank roles -> its contract
(counterpart of ``mpi4dl_tpu/analysis/contracts/extract.py``).

One contract per family, each rank a section of the JAX schema's shape
(``ranks[<rank>]``):

- ``collectives``: per scope path and class, the counted ops' count and
  bytes (``obs.comm_stats``: a transfer counts on its receiving side);
- ``axis_collectives``: per mesh dimension (``tiles``, ``data``,
  ``stage``, ``data_tiles``, ``data_stage``; ``<adhoc>`` for a group the
  mesh did not build) and class;
- ``scopes``: the scope paths the step opened (``obs.scopes.
  recording_paths``);
- ``overlap``: ``obs.overlap.structural_overlap`` of the records (async
  and sync counts, bytes, structurally exposed bytes per scope and class).

Beside them: ``inputs`` (per rank, the batch's dtypes and shapes and the
state's leaf count and bytes: the counterpart of the JAX ``shardings``),
a family-wide ``ircheck`` section of finding counts (``{}`` when clean),
and the meta fields ``schema``, ``engine`` and ``torch``; as in the JAX
diff, only ``schema`` and ``engine`` are gated and ``torch`` is recorded.

The JAX ``lowerings`` section (the retrace budget) has no counterpart: an
eager step is not traced, so there is nothing to count.

An eager step issues each op where XLA compiles a scan body once, so the
port's numbers are its own (``sp`` rank 0 posts over a hundred permutes
where the JAX golden counts 20): the goldens are the port's, and parity
with the JAX gate is held on the diff's logic, not on its numbers.
"""

from __future__ import annotations

from typing import Dict, Sequence

CONTRACT_SCHEMA = 1
UNSCOPED = "<unscoped>"
ADHOC = "<adhoc>"


def _counted_tree(records: Sequence[dict], key) -> Dict[str, Dict[str, Dict[str, int]]]:
    out: Dict[str, Dict[str, Dict[str, int]]] = {}
    for r in records:
        if not r["counted"]:
            continue
        e = out.setdefault(key(r), {}).setdefault(r["cls"], {"count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += r["bytes"]
    return sorted_nested(out)


def rank_section(role: dict) -> dict:
    """One rank's section of the contract (module docstring)."""
    from mpi4dl_tpu_torch.obs.overlap import structural_overlap

    records = role["records"]
    return {
        "collectives": _counted_tree(records, lambda r: r["scope"] or UNSCOPED),
        "axis_collectives": _counted_tree(records, lambda r: r["dim"] or ADHOC),
        "scopes": sorted(role["scopes"]),
        "overlap": structural_overlap(records),
    }


def contract_of(family: str, roles: Sequence[dict]) -> dict:
    """The contract of ``family`` from its recorded roles."""
    import torch

    from mpi4dl_tpu_torch.analysis.ircheck import check_roles, finding_counts

    return {
        "schema": CONTRACT_SCHEMA,
        "engine": family,
        "torch": torch.__version__,
        "ranks": {str(r["rank"]): rank_section(r) for r in roles},
        "inputs": {str(r["rank"]): r["inputs"] for r in roles},
        "ircheck": finding_counts(check_roles(roles, family)),
    }


def sorted_nested(d: dict) -> dict:
    """Recursively key-sort so golden JSON files diff cleanly."""
    return {k: sorted_nested(v) if isinstance(v, dict) else v for k, v in sorted(d.items())}

