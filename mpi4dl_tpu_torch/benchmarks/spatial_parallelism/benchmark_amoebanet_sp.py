"""Spatial-parallel amoebanet training on synthetic data, one image tile per rank
(counterpart of benchmarks/spatial_parallelism/benchmark_amoebanet_sp.py).

    torchrun --nproc-per-node 4 -m \
        mpi4dl_tpu_torch.benchmarks.spatial_parallelism.benchmark_amoebanet_sp \
        --image-size 64 --num-layers 3 --batch-size 2 --steps-per-epoch 3 \
        --device cpu       # four gloo ranks; without --device cpu, NCCL cards

See mpi4dl_tpu_torch/benchmarks/common.py for the flags.
"""

from mpi4dl_tpu_torch.benchmarks.common import run

if __name__ == "__main__":
    run("sp", "amoebanet")
