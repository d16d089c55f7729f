"""Train a few steps on synthetic data.

    python -m mpi4dl_tpu_torch --model amoebanet --image-size 1024 \\
        --num-layers 18 --num-filters 416 --num-classes 1000 --batch-size 1 \\
        --precision bf_16 --pallas-conv --no-remat --steps 4

builds what the JAX package's ``bench._build_step`` builds (SGD, lr from
``--lr``, random weights from ``--seed``) and prints one line per step
(loss, img/s) and a last JSON line with the kernels' launch counts.  It
trains on one device: the spatial flags are ignored, as the JAX package's
``lp`` family ignores them; the spatial-parallel runners are
``mpi4dl_tpu_torch/benchmarks/spatial_parallelism/``.
"""

from __future__ import annotations

import json
import time

import torch

from mpi4dl_tpu_torch.config import config_from_args, get_parser, resolve_pallas_conv
from mpi4dl_tpu_torch.device import resolve_device
from mpi4dl_tpu_torch.models import build_model
from mpi4dl_tpu_torch.ops import halo_conv
from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step


def main(argv=None) -> None:
    p = get_parser()
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev)
    opt = Optimizer(cfg.optimizer, lr=cfg.lr, momentum=cfg.momentum)
    step = make_train_step(
        model, opt, parts=cfg.parts, compute_dtype=cfg.compute_dtype,
        remat=cfg.remat, pallas_conv=resolve_pallas_conv(cfg.pallas_conv),
    )
    state = TrainState.create(model, opt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed + 1)
    shape = (cfg.batch_size, cfg.image_size, cfg.image_size, 3)
    halo_conv.reset_launch_counts()
    for i in range(args.steps):
        x = torch.randn(shape, generator=gen, device=dev)
        y = torch.randint(0, cfg.num_classes, (cfg.batch_size,),
                          generator=gen, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state, x, y)
        loss = float(m["loss"])  # synchronises
        dt = time.perf_counter() - t0
        print(f"step {i}: loss {loss:.6f}  {cfg.batch_size / dt:.3f} img/s "
              f"({dt * 1e3:.1f} ms, {dev})", flush=True)
    print(json.dumps({"launches": dict(halo_conv.LAUNCHES)}), flush=True)


if __name__ == "__main__":
    main()
