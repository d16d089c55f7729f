"""The recorded-collective contract gate (counterpart of
``mpi4dl_tpu/analysis/contracts``).

The JAX gate lowers each engine family on the virtual mesh and pins a
contract extracted from the compiled artifact.  An eager step has no
artifact: the port runs every rank role of each family once on real 32²
CPU tensors on the ``fake`` process group (``engines.py``) and pins what
each rank issued (``extract.py``): per rank, the collectives by scope path
and class, by mesh dimension and class, the scope paths opened and the
structural overlap; the roles' inputs; and the cross-rank verifier's
finding counts (``analysis/ircheck``).  An extra all-gather in a halo
exchange fails the gate with the scope named, before a four-card step
shows it.

Goldens: ``mpi4dl_tpu_torch/analysis/contracts/goldens/<family>.json``,
``goldens/quant_int8/<family>.json`` (``--quant int8``, with the byte-ratio
gate against the raw goldens) and ``goldens/kernels.json`` (the Hopper
kernels' resources, ``analysis/pallascheck``; written on a card).
``python -m mpi4dl_tpu_torch.analysis contracts`` diffs (exit 0 clean, 1
drift, 2 usage or environment); ``--update`` rewrites the goldens.
"""
