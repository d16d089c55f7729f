"""GEMS training of amoebanet on synthetic data, one pipeline stage per rank,
the mirror stream on the same ranks in reverse (counterpart of
benchmarks/gems_master_model/benchmark_amoebanet_gems_master.py).

    torchrun --nproc-per-node 4 -m \
        mpi4dl_tpu_torch.benchmarks.gems_master_model.benchmark_amoebanet_gems_master \
        --split-size 4 --parts 1 --times 1 --batch-size 2 --image-size 32 \
        --num-layers 3 --num-filters 16 --steps-per-epoch 3 \
        --device cpu       # four gloo ranks; without --device cpu, NCCL cards

``--batch-size`` (per data replica) is 2 x ``--times`` x ``--parts``
micro-batches; ``--data-parallel 2 --split-size 2`` runs DP x GEMS on the
same four ranks; ``--schedule 1f1b`` the dual 1F1B.  See
mpi4dl_tpu_torch/benchmarks/common.py for the flags.
"""

from mpi4dl_tpu_torch.benchmarks.common import run

if __name__ == "__main__":
    run("gems", "amoebanet")
