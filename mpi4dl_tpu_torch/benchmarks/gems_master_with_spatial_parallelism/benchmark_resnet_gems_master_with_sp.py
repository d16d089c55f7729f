"""SP + GEMS training of resnet on synthetic data: the spatial region on one
tile per rank, the tail pipelined over ``--split-size`` stages with GEMS's
two streams (counterpart of
benchmarks/gems_master_with_spatial_parallelism/benchmark_resnet_gems_master_with_sp.py).

    torchrun --nproc-per-node 4 -m \
        mpi4dl_tpu_torch.benchmarks.gems_master_with_spatial_parallelism.benchmark_resnet_gems_master_with_sp \
        --num-spatial-parts 2 --slice-method vertical --split-size 2 \
        --spatial-until 2 --num-layers 1 --image-size 32 \
        --batch-size 4 --parts 1 --times 1 --steps-per-epoch 3 \
        --device cpu       # four gloo ranks; without --device cpu, NCCL cards

Ranks are row-major over (data, stage, sph, spw): here stage 2 x 2 tiles.
``--batch-size`` (per data replica) must divide over the stages and into 2
x ``--times`` x ``--parts`` micro-batches; ``--local-DP`` takes the
batch_split junction.  See mpi4dl_tpu_torch/benchmarks/common.py.
"""

from mpi4dl_tpu_torch.benchmarks.common import run

if __name__ == "__main__":
    run("gems_sp", "resnet")
