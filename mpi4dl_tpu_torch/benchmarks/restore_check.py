"""Restore a checkpoint directory through a runner and hold every restored
leaf against the checkpoint's bytes.

    python -m mpi4dl_tpu_torch.benchmarks.restore_check lp amoebanet \\
        --image-size 2048 --num-layers 18 --num-filters 416 --num-classes 1000 \\
        --batch-size 1 --precision bf_16 --steps-per-epoch 4 --checkpoint-dir DIR

runs ``benchmarks/common.run(family, model, flags)`` (one process, the
card unless ``--device cpu``).  Once the runner has restored the newest
valid checkpoint, every leaf of its state is compared, bit for bit, with
the leaf as the checkpoint holds it.  A checkpoint saved under another
layout (say the ``sp`` runner on four ranks) restores elastically into
the one-process ``lp`` runner's state.  The last line is one JSON object:
the step, whether the restore was elastic, the leaves compared and the
number that differ, and the restore's ms.  Exits non-zero when no
checkpoint was restored or a leaf differs.
"""

from __future__ import annotations

import json
import sys

import torch

from mpi4dl_tpu_torch.benchmarks.common import run
from mpi4dl_tpu_torch.checkpoint import load_arrays, state_leaves


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    family, model, flags = argv[0], argv[1], argv[2:]
    seen = {}

    def on_restore(state, mgr):
        saved, step = load_arrays(mgr.last_restore.path)
        leaves = state_leaves(state)
        seen.update(step=step, leaves=len(leaves), saved_leaves=len(saved),
                    differing=sum(not torch.equal(leaf.full(), saved[f"leaf_{i}"])
                                  for i, leaf in enumerate(leaves) if leaf.held))

    out = run(family, model, flags, on_restore=on_restore)
    ok = bool(seen) and seen["differing"] == 0 and seen["leaves"] == seen["saved_leaves"]
    print(json.dumps({"restored": bool(seen), **seen, "elastic": out["elastic"],
                      "restore_ms": (out["checkpoint"] or {}).get("restore_ms"),
                      "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
