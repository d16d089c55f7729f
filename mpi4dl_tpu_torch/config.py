"""Configuration / flags (counterpart of ``mpi4dl_tpu/config.py``).

The parser keeps the JAX package's flag vocabulary (itself the reference's,
``src/torchgems/parser.py``) and its defaults.  The port runs the
single-device engine and single-level spatial parallelism (D1 and D2); a
flag that asks for an engine not ported yet raises NotImplementedError
naming its ROADMAP item instead of being ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple

import torch


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
    stripe_bwd: bool = False
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
        unported = [
            (self.spatial_size > 0 and len(set(self.num_spatial_parts)) > 1,
             "multi-level spatial parallelism (a --num-spatial-parts list)",
             "A11"),
            (self.split_size > 1 or self.balance is not None,
             "layer/pipeline parallelism (--split-size > 1, --balance)", "A7"),
            (self.data_parallel > 1 or self.local_dp_lp > 1,
             "data parallelism (--data-parallel, --local-DP)", "A7"),
            (self.enable_gems or self.times > 1
             or self.enable_master_comm_opt,
             "GEMS (--enable-gems, --times)", "A8"),
            (self.app != 3 or self.checkpoint_dir is not None,
             "data loading and checkpoints (--app 1/2, --checkpoint-dir)",
             "A10"),
            (self.stripe_bwd, "stripe-wise backward (--stripe-bwd)", "A11"),
            (self.quant_collectives != "off",
             "quantized collectives (--quant)", "A13"),
        ]
        for asked, what, item in unported:
            if asked:
                raise NotImplementedError(
                    f"{what} is not ported to PyTorch yet (ROADMAP {item})"
                )


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
    p.add_argument("--quant", dest="quant_collectives", type=str, default="off")
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
