"""Parameter placement over the mesh's two axes (counterpart of
``valor_tpu/parallel/partition.py``).

The JAX package places every parameter leaf by a ``PartitionSpec``
(``param_spec``, a copy of its rules read on the JAX path of each port
parameter, ``train/optimizer.py:flax_path``): Megatron column and row sharding
of the transformer matmuls over ``model``, and with ``fsdp`` the first dim
that the model axis leaves free and the data axis divides, for leaves of at
least 2^14 elements.  GSPMD then inserts the collectives.  The port places the
same leaves and writes the collectives by hand:

  * tensor parallelism (``ops/layers.py``, ``models/videoswin.py``): a
    ``MultiHeadAttention`` runs num_heads / M query heads and kv_heads / M K/V
    heads a rank (query, key and value split by output rows, ``out`` by input
    columns), an ``MlpBlock`` splits ``fc1`` by rows and ``fc2`` by columns,
    and VideoSwin's ``WindowAttention3D`` splits its fused ``qkv`` by heads and
    ``proj`` by columns;
  * ``fsdp`` (``parallel/fsdp.py``): a rank holds its block of the leaf on
    one dim, gathered where the module reads it;
  * ZeRO-1 (``zero_optimizer``, ``train/optimizer.py``): the optimizer state of
    a leaf that neither of them splits, on dim 0 (``mesh.py:zero_sharded``), as
    the JAX package's ``shard_opt_state`` leaves model-sharded moments alone.

Layouts differ between the packages: the port's ``Dense`` weight is [out, in]
where the JAX kernel is [in, out], its convs are OIHW where the JAX ones are
HWIO; ``jax_dims`` maps one to the other, so a JAX "column" split is the
port's dim 0 and a "row" split its dim 1.

Kept placement differences (ROADMAP Queue 3, F11): a module whose heads (or
kv_heads) do not divide by M stays whole on every model rank, where the JAX
spec may still split its columns mid-head (``plan(...).f11``); and the fused
``qkv`` kernel is split by heads (rows q, k and v of rank r's heads), where
the JAX spec cuts its output dim into M contiguous blocks.  Both leave each
rank 1/M of a split leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from valor_tpu_torch.parallel import mesh as P
from valor_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, ZERO_MIN_ELEMS, zero_sharded

Spec = Tuple[Optional[str], ...]  # one mesh axis (or None) a JAX dim; () replicated


def param_spec(path_str: str, ndim: int) -> Spec:
    """The JAX package's spec of the leaf at ``path_str`` (its JAX path, JAX
    layout, ``ndim`` dims): ``valor_tpu/parallel/partition.py:param_spec``."""
    p = path_str
    last = p.rsplit("/", 1)[-1]
    is_kernel = last == "kernel"
    is_bias = last == "bias"
    if "/attn/" in p or p.endswith("attn/qkv/kernel") or "/qkv/" in p:
        if any(f"/{n}/" in p for n in ("query", "key", "value")) or "/qkv/" in p:
            if is_kernel and ndim == 2:
                return (None, MODEL_AXIS)  # column parallel
            if is_bias and ndim == 1:
                return (MODEL_AXIS,)
        if "/out/" in p or "/proj/" in p:
            if is_kernel and ndim == 2:
                return (MODEL_AXIS, None)  # row parallel
            return ()
    if "/mlp/" in p:
        if "fc1" in p:
            if is_kernel and ndim == 2:
                return (None, MODEL_AXIS)
            if is_bias and ndim == 1:
                return (MODEL_AXIS,)
        if "fc2" in p and is_kernel and ndim == 2:
            return (MODEL_AXIS, None)
    return ()


def _divisible(shape, spec: Spec, sizes: Dict[str, int]) -> bool:
    """Whether every dim that ``spec`` splits divides by its axis's size."""
    return all(ax is None or dim % sizes[ax] == 0 for dim, ax in zip(shape, spec))


def jax_dims(path_str: str, ndim: int) -> List[int]:
    """For each dim of the port's tensor, the JAX dim it holds
    (``models/bridge.py:params_from_jax``: only kernels change layout)."""
    if path_str.rsplit("/", 1)[-1] != "kernel" or ndim < 2:
        return list(range(ndim))
    return {2: [1, 0], 4: [3, 2, 0, 1], 5: [4, 3, 0, 1, 2]}[ndim]


def jax_spec(path_str: str, shape, n_data: int, n_model: int, fsdp: bool) -> Spec:
    """The spec that the JAX package's ``shard_params(params, mesh, fsdp)``
    gives the leaf of JAX ``shape`` on a (n_data, n_model) mesh, padded to
    one entry a dim."""
    sizes = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
    ndim = len(shape)
    spec = param_spec(path_str, ndim)
    if spec and not _divisible(shape, spec, sizes):
        spec = ()
    axes = list(spec) + [None] * (ndim - len(spec))
    if fsdp and n_data > 1 and ndim >= 1 and math.prod(shape) >= ZERO_MIN_ELEMS:
        for i, (dim, ax) in enumerate(zip(shape, axes)):
            if ax is None and dim % n_data == 0:
                axes[i] = DATA_AXIS
                break
    if n_model == 1:  # a model axis of one device splits nothing
        axes = [None if a == MODEL_AXIS else a for a in axes]
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a parameter of whole ``shape`` (the port's layout) lives:
    ``model_dim`` split over the model axis, in ``model_groups`` equal parts
    each cut into M blocks (3 for a fused qkv: rank r holds its heads' rows of
    q, k and v); ``data_dim`` split over the data axis by ``fsdp``;
    ``model_partial``: replicated, but each model rank's use reads only its
    heads' part (VideoSwin's bias tables), so its gradient is summed over the
    model axis."""

    shape: Tuple[int, ...]
    path: str = ""  # the JAX path
    model_dim: Optional[int] = None
    model_groups: int = 1
    data_dim: Optional[int] = None
    model_partial: bool = False

    @property
    def split(self) -> bool:
        return self.model_dim is not None or self.data_dim is not None


@dataclasses.dataclass
class Plan:
    """The placement of every parameter (port name -> ``Placement``) on a
    (n_data, n_model) mesh; ``tp``: the modules split over the model axis
    (name -> kind); ``f11``: the JAX paths of the leaves that the JAX package
    splits over the model axis and the port keeps whole."""

    n_data: int
    n_model: int
    placements: Dict[str, Placement]
    tp: Dict[str, str]
    f11: List[str]



def _tp_kind(mod: nn.Module) -> Optional[str]:
    from valor_tpu_torch.models.videoswin import WindowAttention3D
    from valor_tpu_torch.ops.layers import MlpBlock, MultiHeadAttention

    for cls, kind in ((MultiHeadAttention, "attention"), (MlpBlock, "mlp"), (WindowAttention3D, "window")):
        if isinstance(mod, cls):
            return kind
    return None


def _tp_leaves(kind: str, mod: nn.Module, n_model: int) -> Optional[Dict[str, Tuple[int, int]]]:
    """{parameter path under the module: (port dim, groups)} of a module that
    the port splits over ``n_model`` ranks; None where it stays whole (heads
    that do not divide)."""
    if kind == "attention":
        if mod.num_heads % n_model or mod.kv_heads % n_model:
            return None
        cols = {f"{d}.{p}": (0, 1) for d in ("query", "key", "value") for p in ("weight", "bias")}
        return dict(cols, **{"out.weight": (1, 1)})
    if kind == "window":
        if mod.num_heads % n_model:
            return None
        out = {"qkv.weight": (0, 3), "proj.weight": (1, 1)}
        if mod.qkv.bias is not None:
            out["qkv.bias"] = (0, 3)
        return out
    if mod.fc1.weight.shape[0] % n_model:
        return None
    return {"fc1.weight": (0, 1), "fc1.bias": (0, 1), "fc2.weight": (1, 1)}


def plan(model: nn.Module, n_data: int, n_model: int, fsdp: bool = False) -> Plan:
    """The placement of ``model``'s parameters on a (n_data, n_model) mesh, by
    the rule of the JAX package's ``shard_params``: the same leaves split over
    ``model`` and over ``data``."""
    from valor_tpu_torch.train.optimizer import flax_path

    owner: Dict[str, Tuple[str, nn.Module]] = {}  # parameter -> (flax path, owning module)
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            owner[f"{mod_name}.{p_name}" if mod_name else p_name] = (flax_path(mod, mod_name, p_name), mod)
    port_tp: Dict[str, Tuple[int, int]] = {}
    partial: set = set()
    tp: Dict[str, str] = {}
    if n_model > 1:
        for mod_name, mod in model.named_modules():
            kind = _tp_kind(mod)
            leaves = _tp_leaves(kind, mod, n_model) if kind else None
            if leaves is None:
                continue
            tp[mod_name] = kind
            port_tp.update({f"{mod_name}.{k}": v for k, v in leaves.items()})
            if kind == "window":
                partial.add(f"{mod_name}.relative_position_bias_table")
    placements: Dict[str, Placement] = {}
    f11: List[str] = []
    for name, p in model.named_parameters():
        path, _ = owner[name]
        shape = tuple(p.shape)
        jdims = jax_dims(path, len(shape))
        jshape = [0] * len(shape)
        for port_d, jax_d in enumerate(jdims):
            jshape[jax_d] = shape[port_d]
        axes = jax_spec(path, jshape, n_data, n_model, fsdp)
        to_port = {jax_d: port_d for port_d, jax_d in enumerate(jdims)}
        data_dim = next((to_port[d] for d, ax in enumerate(axes) if ax == DATA_AXIS), None)
        model_dim, groups = port_tp.get(name, (None, 1))
        if (MODEL_AXIS in axes) != (model_dim is not None):
            if model_dim is not None:
                raise AssertionError(f"{path}: the port splits a leaf that the JAX spec keeps whole")
            f11.append(path)
        placements[name] = Placement(shape, path, model_dim, groups, data_dim, name in partial)
    return Plan(n_data, n_model, placements, tp, f11)


# -- blocks and wholes ----------------------------------------------------------

def _cut(t: torch.Tensor, dim: int, n: int, groups: int) -> List[torch.Tensor]:
    """``t``'s ``n`` blocks on ``dim``, each the concatenation of its block of
    every one of ``groups`` equal parts."""
    parts = t.unflatten(dim, (groups, -1)).chunk(n, dim + 1)
    return [b.flatten(dim, dim + 1) for b in parts]


def _join(blocks, dim: int, groups: int) -> torch.Tensor:
    """``_cut`` undone."""
    parts = [b.unflatten(dim, (groups, -1)) for b in blocks]
    return torch.cat(parts, dim + 1).flatten(dim, dim + 1)


def local(t: torch.Tensor, pl: Placement, model_rank: Optional[int] = None, n_model: Optional[int] = None,
          data_rank: Optional[int] = None, n_data: Optional[int] = None) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` (contiguous; ranks and
    worlds this process's by default)."""
    if pl.model_dim is not None:
        n = P.model_world() if n_model is None else n_model
        r = P.model_rank() if model_rank is None else model_rank
        t = _cut(t, pl.model_dim, n, pl.model_groups)[r]
    if pl.data_dim is not None:
        n = P.data_world() if n_data is None else n_data
        r = P.data_rank() if data_rank is None else data_rank
        t = t.chunk(n, pl.data_dim)[r]
    return t.contiguous()


def whole(t: torch.Tensor, pl: Placement) -> torch.Tensor:
    """The whole tensor of this rank's block ``t``, gathered over the data
    and the model axis (a collective every rank runs); ``t`` itself where
    nothing splits it."""
    from valor_tpu_torch.parallel import collectives as C

    if pl.data_dim is not None:
        t = C.all_gather_dim(t, pl.data_dim, DATA_AXIS)
    if pl.model_dim is not None:
        t = _join(list(C.gather_arrays(t, MODEL_AXIS).unbind(0)), pl.model_dim, pl.model_groups)
    return t


def placements_of(model: nn.Module) -> Dict[str, Placement]:
    """The placement ``shard_model`` gave ``model``'s parameters ({} where it
    was not placed)."""
    return getattr(model, "placements", None) or {}


def zero_split(pl: Placement, n_data: int) -> bool:
    """Whether ZeRO-1 splits the optimizer state of a parameter placed at
    ``pl`` over ``n_data`` data ranks (the JAX package's ``shard_opt_state``:
    only leaves that the parameter placement left whole)."""
    return n_data > 1 and not pl.split and zero_sharded(pl.shape, n_data)


def shard_model(model: nn.Module, fsdp: bool = False) -> Plan:
    """Place ``model`` (whole, its weights loaded) on this process's mesh
    (``mesh.make_mesh``), in place: the tensor-parallel modules run their
    share of the heads and hidden units, each split parameter becomes this
    rank's block (same name, same ``state_dict`` key), and ``fsdp``'s
    parameters are gathered where their modules read them
    (``parallel/fsdp.py``).  Records the placement as ``model.placements``;
    returns the plan."""
    from valor_tpu_torch.parallel import fsdp as F

    pl = plan(model, P.data_world(), P.model_world(), fsdp)
    modules = dict(model.named_modules())
    for mod_name in pl.tp:
        set_tensor_parallel(modules[mod_name], P.model_world(), P.model_rank())
    by_module: Dict[str, Dict[str, int]] = {}
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            place = pl.placements[name]
            if not place.split:
                continue
            mod_name, _, p_name = name.rpartition(".")
            mod = modules[mod_name]
            block = nn.Parameter(local(p.data, place), requires_grad=p.requires_grad)
            setattr(mod, p_name, block)
            if place.data_dim is not None:
                by_module.setdefault(mod_name, {})[p_name] = place.data_dim
    for mod_name, dims in by_module.items():
        F.gather_on_read(modules[mod_name], dims)
    model.placements = pl.placements
    return pl


def set_tensor_parallel(mod: nn.Module, n_model: int, model_rank: int) -> None:
    """Make a ``MultiHeadAttention``, ``MlpBlock`` or ``WindowAttention3D``
    run its share of ``n_model`` ranks (its parameters are cut by the
    caller): its inputs pass ``copy_to_model`` and its row-parallel output
    ``reduce_from_model``."""
    kind = _tp_kind(mod)
    if kind == "attention":
        mod.num_heads //= n_model
        mod.kv_heads //= n_model
        mod.model_cols = (model_rank, n_model)
        mod.out.row_parallel = True
    elif kind == "window":
        mod.num_heads //= n_model
        mod.head_offset = model_rank * mod.num_heads
        mod.proj.row_parallel = True
    else:
        mod.fc2.row_parallel = True
    mod.tensor_parallel = True


def whole_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s ``state_dict`` with every split parameter gathered whole (a
    collective every rank runs): a checkpoint's layout at any mesh."""
    places = placements_of(model)
    sd = model.state_dict()
    if not places:
        return sd
    return {k: whole(v, places[k]) if k in places and places[k].split else v for k, v in sd.items()}


@torch.no_grad()
def load_whole(model: nn.Module, state_dict, strict: bool = True) -> None:
    """Copy a whole ``state_dict`` (a checkpoint's, any mesh's) into a placed
    ``model``: this rank's block of each split parameter."""
    places = placements_of(model)
    if not places:
        model.load_state_dict(state_dict, strict=strict)
        return
    mine = {k: local(v, places[k]) if k in places and places[k].split else v for k, v in state_dict.items()}
    model.load_state_dict(mine, strict=strict)
