"""Configuration / flags (counterpart of ``mpi4dl_tpu/config.py``).

The parser keeps the JAX package's flag vocabulary (itself the reference's,
``src/torchgems/parser.py``) and its defaults.  The port runs the
single-device engine, data parallelism, spatial parallelism (D1 and D2,
the ``gather`` and ``batch_split`` junctions, multi-level
``--num-spatial-parts`` lists, ``--stripe-bwd``), the LP/PP pipelines
(GPipe, 1F1B), GEMS (``--times``), SP x PP / SP + GEMS and the quantized
collectives (``--quant``, ``quant/``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# Environment-hatch registry (counterpart of ``mpi4dl_tpu/config.py:38``)
#
# Every ``MPI4DL_*`` environment variable the port reads is declared here,
# with its effective default and one line of doc.  The port's analyzer
# (``python -m mpi4dl_tpu_torch.analysis``, rule ``env-hatch``) parses this
# table from source and holds both directions: a read of an undeclared name
# is a finding, and so is a declared name that nothing reads.  The README's
# table of the port's hatches is :func:`hatches_markdown`.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Hatch:
    """One declared environment hatch."""

    name: str
    default: str  # the effective default when the variable is unset
    doc: str
    internal: bool = False  # plumbing between the port's own processes


HATCHES: Dict[str, Hatch] = {
    h.name: h
    for h in (
        Hatch("MPI4DL_SQRT_GROUPS", "0",
              "Checkpoint groups of remat='sqrt'; 0 = about sqrt(cells) "
              "(the bench pins 16)."),
        Hatch("MPI4DL_REMAT_OPS", "0",
              "1 = a checkpoint per op inside composite cells under any "
              "outer remat level (the bench retries with it on OOM)."),
        Hatch("MPI4DL_NO_HSTRIPE", "0",
              "1 = the striped single-device ResNet branch keeps the library "
              "conv."),
        Hatch("MPI4DL_HSTRIPE_RUN", "auto",
              "Block-level H-striping: 0 = off, 1 = on (no BatchNorm "
              "warning), auto = on with the warning."),
        Hatch("MPI4DL_HSTRIPE_EXACT", "0",
              "1 = striped BatchNorm takes whole-input statistics (the "
              "striped run and the stripe-wise backward)."),
        Hatch("MPI4DL_STRIPE_BWD", "0",
              "Stripe-wise forward and backward of eligible stride-1 blocks "
              "(ops/stripe_bwd.py): 1 = the spatially sharded blocks, all = "
              "every eligible block."),
        Hatch("MPI4DL_STRIPE_BUDGET", str(64 * 1024 * 1024),
              "Bytes of one stripe's working set in the stripe-wise "
              "backward; the stripe count follows from it."),
        Hatch("MPI4DL_PALLAS_CONV", "0",
              "1 = the bench routes eligible spatial convs through K1/K2."),
        Hatch("MPI4DL_QUANT_COLLECTIVES", "<unset>",
              "Quantized-collective policy, over --quant: `off`, one mode "
              "(`int8`|`fp8`|`int4`) or per class `junction=int4,"
              "respatial=int8,grad=int8,handoff=int8[,block=N]`."),
        Hatch("MPI4DL_NO_RESPATIAL_FAST", "0",
              "1 = level moves take the full gather and slice instead of "
              "the local slice and the coarsening ring."),
        Hatch("MPI4DL_FAULT", "<unset>",
              "Fault injection `<kind>@<step>[:arg]` (nan_loss, nan_batch, "
              "raise, sigterm, corrupt_ckpt, lost_shard_files, reshape, "
              "stall_data, oom_compile, oom_step, mesh_shrunk, slow_step, "
              "io_error)."),
        Hatch("MPI4DL_FAULT_RANKS", "<unset>",
              "Comma-list of the process ranks MPI4DL_FAULT fires on; unset "
              "= every rank."),
        Hatch("MPI4DL_CKPT_HOST_BYTES", str(1 << 30),
              "Bytes of copied-but-unwritten checkpoint leaves the "
              "background writer holds before the training thread waits."),
        Hatch("MPI4DL_WATCHDOG_SECS", "0",
              "Step watchdog budget in seconds (0 = off); --watchdog-secs "
              "overrides."),
        Hatch("MPI4DL_WATCHDOG_COMPILE_SECS", "10x step budget",
              "Watchdog budget of a process's first step; "
              "--watchdog-compile-secs overrides."),
        Hatch("MPI4DL_WATCHDOG_ESCALATE", "0",
              "Stall dumps of one step before the watchdog writes a `hang` "
              "crash marker and ends the leg (0 = never)."),
        Hatch("MPI4DL_SUPERVISE_MAX_ATTEMPTS", "6",
              "Elastic supervisor: leg launches before it gives up."),
        Hatch("MPI4DL_SUPERVISE_BACKOFF", "1.0",
              "Elastic supervisor: base seconds of the exponential retry "
              "backoff."),
        Hatch("MPI4DL_SUPERVISE_BACKOFF_CAP", "30",
              "Elastic supervisor: ceiling of the backoff in seconds."),
        Hatch("MPI4DL_QUARANTINE_STEPS", "<unset>",
              "Comma-list of global steps the supervised loop skips (the "
              "supervisor's poison-batch exclusion)."),
        Hatch("MPI4DL_CRASH_MARKER", "<unset>",
              "Internal: where a supervised leg writes its crash marker.",
              internal=True),
        Hatch("MPI4DL_FLEET_DEVICES", "8",
              "Fleet scheduler: cards in the shared pool."),
        Hatch("MPI4DL_FLEET_POISON_ATTEMPTS", "2",
              "Fleet scheduler: failed supervisor runs before a job is "
              "quarantined as poison."),
        Hatch("MPI4DL_FLEET_JOB", "<unset>",
              "Internal: the fleet job a leg belongs to, stamped into its "
              "result.", internal=True),
        Hatch("MPI4DL_FLEET_SLICE_DEVICES", "<unset>",
              "Internal: cards of the fleet slice a leg is pinned to.",
              internal=True),
        Hatch("MPI4DL_NO_GUARD", "0",
              "1 = no anomaly guard (finite-loss check, rollback, "
              "poison-batch skip)."),
        Hatch("MPI4DL_GUARD_GRAD_NORM", "0",
              "Gradient-norm limit of the anomaly guard (0 = off)."),
        Hatch("MPI4DL_FLIGHT_STEPS", "64",
              "Steps the flight recorder keeps for its `flight.json` dump."),
        Hatch("MPI4DL_NO_FLIGHT", "0",
              "1 = no flight recorder."),
        Hatch("MPI4DL_METRICS_PORT", "<unset>",
              "Port of `python -m mpi4dl_tpu_torch.obs metrics --serve`; "
              "unset = files only."),
    )
}


def hatches_markdown(include_internal: bool = False) -> str:
    """The registry as the README's table of the port's hatches."""
    lines = ["| Hatch | Default | Effect |", "| --- | --- | --- |"]
    for h in HATCHES.values():
        if h.internal and not include_internal:
            continue
        lines.append(f"| `{h.name}` | `{h.default}` | {h.doc} |")
    return "\n".join(lines)


@dataclasses.dataclass
class ParallelConfig:
    # --- model / problem (reference parser.py) ---
    model: str = "resnet"  # resnet | amoebanet
    batch_size: int = 32
    parts: int = 1  # micro-batches per step (GPipe "parts")
    split_size: int = 1  # pipeline stages (LP splits)
    schedule: str = "gpipe"  # pipeline schedule: gpipe | 1f1b
    num_spatial_parts: Tuple[int, ...] = (4,)
    spatial_size: int = 1  # how many leading splits are spatial
    times: int = 1  # GEMS replication factor
    image_size: int = 32
    num_epochs: int = 1
    num_layers: int = 18
    num_filters: int = 416
    num_classes: int = 10
    balance: Optional[Tuple[int, ...]] = None
    halo_d2: bool = False
    fused_layers: int = 0
    local_dp_lp: int = 1
    slice_method: str = "square"
    app: int = 3  # 1=image folder, 2=cifar-like, 3=synthetic
    datapath: str = "./train"
    enable_master_comm_opt: bool = False
    num_workers: int = 0
    precision: str = "fp_32"  # fp_32 | bf_16 | bf_16_all

    # --- additions of the JAX package ---
    data_parallel: int = 1
    bn_cross_tile: bool = True
    softmax_in_model: bool = False
    enable_gems: bool = False
    lr: float = 0.001
    momentum: float = 0.0
    optimizer: str = "sgd"
    remat: bool = True  # checkpoint each cell
    pallas_conv: Optional[bool] = None  # None = auto = off
    quant_collectives: str = "off"
    stripe_bwd: bool = False  # the runners set MPI4DL_STRIPE_BWD=1
    spatial_until: Optional[object] = None
    verbose: bool = False
    checkpoint_dir: Optional[str] = None
    seed: int = 0

    @property
    def spatial_part_size(self) -> int:
        return self.num_spatial_parts[0]

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.precision in ("bf_16", "bf_16_all") else torch.float32

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.precision == "bf_16_all" else torch.float32

    def validate(self) -> None:
        if self.precision not in ("fp_32", "bf_16", "bf_16_all"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.slice_method not in ("square", "vertical", "horizontal"):
            raise ValueError(f"unknown slice method {self.slice_method!r}")
        assert self.batch_size % self.parts == 0, "batch must divide into parts"
        if self.schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.balance is not None and (len(self.balance) != self.split_size):
            raise ValueError(f"--balance {self.balance} needs {self.split_size} "
                             "entries (--split-size)")
        # A malformed quant spec fails here (ValueError naming the token);
        # the MPI4DL_QUANT_COLLECTIVES hatch is resolved when a step builds.
        from mpi4dl_tpu_torch.quant.policy import QuantPolicy

        QuantPolicy.parse(self.quant_collectives)


def resolve_pallas_conv(setting: Optional[bool]) -> bool:
    """Resolve the tri-state ``pallas_conv`` setting: None = auto = off, the
    JAX package's default.  ``--pallas-conv`` routes the eligible convs
    through the hand-written K1/K2 kernels."""
    return bool(setting) if setting is not None else False


def get_parser() -> argparse.ArgumentParser:
    """Argparse with the JAX package's flag names."""
    p = argparse.ArgumentParser(description="mpi4dl_tpu_torch")
    p.add_argument("--model", type=str, default="resnet")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--parts", type=int, default=1)
    p.add_argument("--split-size", type=int, default=1)
    p.add_argument("--schedule", choices=["gpipe", "1f1b"], default="gpipe")
    p.add_argument("--num-spatial-parts", type=str, default="4")
    p.add_argument("--spatial-size", type=int, default=1)
    p.add_argument("--times", type=int, default=1)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--num-epochs", type=int, default=1)
    p.add_argument("--num-layers", type=int, default=18)
    p.add_argument("--num-filters", type=int, default=416)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--balance", type=str, default=None)
    p.add_argument("--halo-d2", "--halo-D2", dest="halo_d2", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--fused-layers", type=int, default=0)
    p.add_argument("--local-DP", dest="local_dp_lp", type=int, default=1)
    p.add_argument("--slice-method", type=str, default="square")
    p.add_argument("--app", type=int, default=3)
    p.add_argument("--datapath", type=str, default="./train")
    p.add_argument("--enable-master-comm-opt", action="store_true")
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--precision", type=str, default="fp_32")
    p.add_argument("--data-parallel", type=int, default=1)
    p.add_argument("--per-tile-bn", action="store_true")
    p.add_argument("--softmax-in-model", action="store_true")
    p.add_argument("--enable-gems", action="store_true")
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--pallas-conv", action="store_const", const=True,
                   dest="pallas_conv", default=None,
                   help="route stride-1 convs and relu-conv-bn windows "
                        "through the hand-written K1/K2 CUDA kernels")
    p.add_argument("--no-pallas-conv", action="store_const", const=False,
                   dest="pallas_conv")
    p.add_argument("--quant", dest="quant_collectives", type=str,
                   default="off", metavar="SPEC",
                   help="quantized-collective policy: off (default, "
                        "bit-identical), int8|fp8|int4 for every hot class, "
                        "or per-class junction=...,respatial=...,grad=...,"
                        "handoff=...[,block=N]")
    p.add_argument("--stripe-bwd", action="store_true")
    p.add_argument("--spatial-until", default=None, type=_spatial_until_arg)
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    return p


def _int_tuple(s: Optional[str]) -> Optional[Tuple[int, ...]]:
    if s is None or s == "":
        return None
    return tuple(int(x) for x in s.split(","))


def _spatial_until_arg(s):
    if s is None or s == "":
        return None
    return "auto" if s == "auto" else int(s)


def config_from_args(args: argparse.Namespace) -> ParallelConfig:
    cfg = ParallelConfig(
        model=args.model,
        batch_size=args.batch_size,
        parts=args.parts,
        split_size=args.split_size,
        schedule=args.schedule,
        num_spatial_parts=_int_tuple(args.num_spatial_parts) or (4,),
        spatial_size=args.spatial_size,
        times=args.times,
        image_size=args.image_size,
        num_epochs=args.num_epochs,
        num_layers=args.num_layers,
        num_filters=args.num_filters,
        num_classes=args.num_classes,
        balance=_int_tuple(args.balance),
        halo_d2=args.halo_d2,
        fused_layers=args.fused_layers,
        local_dp_lp=args.local_dp_lp,
        slice_method=args.slice_method,
        app=args.app,
        datapath=args.datapath,
        enable_master_comm_opt=args.enable_master_comm_opt,
        num_workers=args.num_workers,
        precision=args.precision,
        data_parallel=args.data_parallel,
        bn_cross_tile=not args.per_tile_bn,
        softmax_in_model=args.softmax_in_model,
        enable_gems=args.enable_gems,
        lr=args.lr,
        remat=not args.no_remat,
        pallas_conv=args.pallas_conv,
        quant_collectives=args.quant_collectives,
        stripe_bwd=args.stripe_bwd,
        spatial_until=args.spatial_until,
        verbose=args.verbose,
        checkpoint_dir=args.checkpoint_dir,
        seed=args.seed,
    )
    cfg.validate()
    return cfg
