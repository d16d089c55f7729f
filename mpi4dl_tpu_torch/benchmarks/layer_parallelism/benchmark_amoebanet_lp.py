"""Layer/pipeline-parallel amoebanet training on synthetic data, one pipeline
stage per rank (counterpart of
benchmarks/layer_parallelism/benchmark_amoebanet_lp.py).

    torchrun --nproc-per-node 4 -m \
        mpi4dl_tpu_torch.benchmarks.layer_parallelism.benchmark_amoebanet_lp \
        --split-size 4 --parts 2 --batch-size 4 --image-size 32 --num-layers 3 --num-filters 16 \
        --schedule 1f1b --steps-per-epoch 3 \
        --device cpu       # four gloo ranks; without --device cpu, NCCL cards

``--data-parallel 2 --split-size 2`` runs DP x PP on the same four ranks;
``--split-size 1 --data-parallel 4`` runs DP.  See
mpi4dl_tpu_torch/benchmarks/common.py for the flags.
"""

from mpi4dl_tpu_torch.benchmarks.common import run

if __name__ == "__main__":
    run("lp", "amoebanet")
