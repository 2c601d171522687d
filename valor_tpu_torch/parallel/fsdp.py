"""Fully sharded parameters over the data axis (``fsdp``; the JAX package's
``shard_params(fsdp=True)``, where GSPMD gathers a leaf at its use and
reduce-scatters its gradient).

A parameter that ``parallel/partition.py`` splits over ``data`` is held as
this rank's block: the ``nn.Parameter`` keeps its name and ``state_dict`` key,
and the optimizer sees the block (its moments, its gradient).  Every read of
the attribute on the module that owns it (``module.weight``, inside or
outside the module's ``forward``: the tied word table that the caption head
and the decoder read, ``compute_kv`` from the decode path, a parent reading a
child's parameter) returns the whole tensor through ``GatherParam``:

  * forward: an all-gather of every data rank's block on the split dim;
  * backward: a reduce-scatter (sum) of the whole gradient into this rank's
    block.

So ``torch.autograd.grad`` over the blocks gives block gradients already
summed over the data ranks; ``train/optimizer.py:GroupedAdam.reduce_grads``
divides them by the data ranks and reduces them no further.  The gathered
tensor that the backward keeps alive is transient.

``unsharded(model)`` gathers every block once for the block inside it
(validation and SCST rollouts, where data ranks hold different numbers of
batches or run no backward): reads return the gathered tensors, with no
collective.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
from torch import nn

from valor_tpu_torch.parallel import collectives as C

_CLASSES: Dict[type, type] = {}


class GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, dim):
        ctx.dim = dim
        return C.all_gather_dim(block.detach(), dim)

    @staticmethod
    def backward(ctx, grad):
        return C.reduce_scatter_dim(grad, ctx.dim), None


def gather_param(block: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole tensor of ``block`` (this rank's block on ``dim``)."""
    if torch.is_grad_enabled() and block.requires_grad:
        return GatherParam.apply(block, dim)
    return C.all_gather_dim(block.detach(), dim)


def _gathering_class(cls: type) -> type:
    """``cls`` with its split parameters read whole."""
    if cls not in _CLASSES:
        def __getattr__(self, name):
            dims = self.__dict__.get("_fsdp_dims")
            if dims is not None and name in dims:
                cached = self.__dict__.get("_fsdp_whole")
                if cached is not None:
                    return cached[name]
                return gather_param(self._parameters[name], dims[name])
            return nn.Module.__getattr__(self, name)

        _CLASSES[cls] = type(cls.__name__, (cls,), {"__getattr__": __getattr__, "__module__": cls.__module__})
    return _CLASSES[cls]


def gather_on_read(module: nn.Module, dims: Dict[str, int]) -> None:
    """Make every read of ``module``'s parameters ``dims`` (name -> the dim
    their blocks split) return the whole tensor."""
    module.__dict__["_fsdp_dims"] = dict(module.__dict__.get("_fsdp_dims") or {}, **dims)
    module.__class__ = _gathering_class(type(module) if type(module) not in _CLASSES.values()
                                        else type(module).__mro__[1])


@contextlib.contextmanager
def unsharded(model: nn.Module) -> Iterator[nn.Module]:
    """Every split parameter of ``model`` gathered once (a collective every
    data rank runs), without autograd, and read from there inside the block;
    nothing to do where nothing is split, or inside another ``unsharded``."""
    mods = [m for m in model.modules() if m.__dict__.get("_fsdp_dims") and m.__dict__.get("_fsdp_whole") is None]
    with torch.no_grad():
        for m in mods:
            m.__dict__["_fsdp_whole"] = {n: C.all_gather_dim(m._parameters[n].detach(), d)
                                         for n, d in m.__dict__["_fsdp_dims"].items()}
    try:
        yield model
    finally:
        for m in mods:
            m.__dict__.pop("_fsdp_whole", None)
