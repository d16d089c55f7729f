"""Per-step communication volume of the engines (counterpart of
``benchmarks/communication/comm_volume_report.py``).

The JAX tool compiles a training step of each engine on a virtual mesh and
counts the collectives in the compiled HLO.  This one runs rank 0's step of
each engine on the ``fake`` process group (``torch.testing._internal.
distributed.fake_pg``: nothing moves, nothing needs a card) with
``obs/comm_stats.py`` recording every collective it issues, and reports
their counts and bytes per class (the JAX tool's JSON: per program
``hlo_collective_stats``' schema).  Programs, at the JAX tool's sizes
(ResNet v2 depth 11, ``--image-size`` 64, ``--batch-size`` 8):

- ``sp_4tile`` (``sp_4tile_d2`` with ``--halo-d2``): the SP step on 4
  vertical tiles, per-conv halos (D1) or fused D2 runs;
- ``pp_4stage``: GPipe over 4 stages, 2 micro-batches of 1;
- ``gems_4stage``: GEMS on the same 4 stages, 2 micro-batches a stream.

D2 posts fewer halo permutes than D1 (one exchange a fused run instead of
one a conv)::

    python -m mpi4dl_tpu_torch.benchmarks.communication.comm_volume_report
    python -m mpi4dl_tpu_torch.benchmarks.communication.comm_volume_report --halo-d2
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional


def programs(image: int, batch: int, d2: bool) -> Dict[str, tuple]:
    """{program: (runner family, runner flags)} at the JAX tool's sizes."""
    net = ["--model", "resnet", "--image-size", str(image), "--num-layers", "11"]
    sp = net + ["--batch-size", str(batch), "--num-spatial-parts", "4",
                "--slice-method", "vertical"] + (["--halo-d2"] if d2 else [])
    return {
        "sp_4tile" + ("_d2" if d2 else ""): ("sp", sp),
        "pp_4stage": ("lp", net + ["--batch-size", "2", "--split-size", "4",
                                   "--parts", "2"]),
        "gems_4stage": ("gems", net + ["--batch-size", "4", "--split-size", "4",
                                       "--parts", "2", "--times", "1"]),
    }


def program_stats(family: str, flags: List[str]) -> dict:
    """Rank 0's recorded collectives a step (``collective_stats``)."""
    from mpi4dl_tpu_torch.benchmarks.mem_probe import probe_role
    from mpi4dl_tpu_torch.config import config_from_args, get_parser

    cfg = config_from_args(get_parser().parse_args(flags))
    return probe_role(cfg, family, 0, instruments=True)["collectives"]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.benchmarks.communication.comm_volume_report")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--halo-d2", action="store_true")
    args = p.parse_args(argv)
    report = {name: program_stats(fam, flags) for name, (fam, flags)
              in programs(args.image_size, args.batch_size, args.halo_d2).items()}
    out = {
        "metric": "per_step_collective_bytes",
        "value": report[next(iter(report))]["total_bytes"],
        "unit": "bytes",
        "config": {"image_size": args.image_size, "batch_size": args.batch_size,
                   "halo_d2": args.halo_d2},
        "programs": report,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
