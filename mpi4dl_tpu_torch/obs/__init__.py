"""Observability for the PyTorch port: only the scope names so far."""

from mpi4dl_tpu_torch.obs.scopes import scope

__all__ = ["scope"]
