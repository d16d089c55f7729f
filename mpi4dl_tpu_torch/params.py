"""Carry weights between the JAX package's parameter pytree and the port.

The JAX package keeps a model's parameters as nested lists and dicts: one
entry per cell, a list per :class:`LayerCell`, a dict per composite cell
keyed by its submodule names, and a dict of arrays per layer (HWIO conv
``kernel``, ``bias``, BN ``scale``/``bias``/``mean``/``var``, Dense
``kernel``/``bias``).  The long-context family keeps a list with one dict
per ``SeqBlock`` (``ln1_scale``, ``wqkv``, ...), which maps to an
``nn.ModuleList`` of the port's ``SeqBlock``.  The port's modules mirror
that tree: the same names, the same layouts.  :func:`from_jax_params`
copies such a tree (of numpy arrays) into a port model;
:func:`to_jax_layout` reads one back out, and :func:`layout_tensors`
gives the same tree holding the live tensors.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mpi4dl_tpu_torch.cells import CellModel, LayerCell
from mpi4dl_tpu_torch.layers import Layer
from mpi4dl_tpu_torch.models.seqblock import SeqBlock

# Modules whose own parameters and buffers are one dict of the pytree.
_LEAVES = (Layer, SeqBlock)


def _sequence(module: nn.Module):
    if isinstance(module, CellModel):
        return module.cells
    if isinstance(module, LayerCell):
        return module.layers
    if isinstance(module, nn.ModuleList):
        return module
    raise TypeError(f"{type(module).__name__} has no list layout")


def _tensors(layer: Layer):
    return {**dict(layer.named_parameters(recurse=False)),
            **dict(layer.named_buffers(recurse=False))}


@torch.no_grad()
def from_jax_params(params, model: nn.Module) -> None:
    """Copy the JAX pytree ``params`` (nested lists/dicts of numpy arrays)
    into ``model``'s parameters and buffers, casting to their dtype."""
    if isinstance(params, (list, tuple)):
        children = list(_sequence(model))
        if len(children) != len(params):
            raise ValueError(
                f"{type(model).__name__}: {len(children)} children, "
                f"{len(params)} pytree entries"
            )
        for child, p in zip(children, params):
            from_jax_params(p, child)
        return
    tensors = _tensors(model) if isinstance(model, _LEAVES) else {}
    for key, value in params.items():
        if key in tensors:
            t = tensors[key]
            src = torch.from_numpy(np.array(value, dtype=np.float32))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{key}: pytree {tuple(src.shape)} vs "
                                 f"model {tuple(t.shape)}")
            t.copy_(src)
        else:
            from_jax_params(value, getattr(model, key))


def layout_tensors(model: nn.Module):
    """The model's parameters and buffers as the JAX pytree, holding the
    live tensors (a checkpoint reads and writes them in place)."""
    if isinstance(model, (CellModel, LayerCell, nn.ModuleList)):
        return [layout_tensors(c) for c in _sequence(model)]
    if isinstance(model, _LEAVES):
        return _tensors(model)
    out = {}
    for name, child in model.named_children():
        sub = layout_tensors(child)
        if sub != {}:
            out[name] = sub
    return out


def to_jax_layout(model: nn.Module):
    """The model's parameters and buffers as the JAX pytree (numpy fp32)."""
    def host(tree):
        if isinstance(tree, list):
            return [host(c) for c in tree]
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        return tree.detach().float().cpu().numpy()

    return host(layout_tensors(model))
