"""Grouped Adam(W) for the port (counterpart of ``valor_tpu/train/optimizer.py``).

Five learning-rate groups (basic, new, clip_visual, clip_text, decoder), each
split into weight decay and no decay, plus frozen parameters.  Labels are
given by the JAX package's parameter path of each parameter (``flax_path``),
so the port labels exactly what the JAX package labels: the port calls a
LayerNorm's scale ``weight``, and a label taken from the port's own names would
decay it.

One update, in the JAX package's order:

  1. frozen gradients are zeroed (before the clip, so they do not count in the
     norm);
  2. every gradient is scaled by min(1, grad_norm / global L2 norm), keeping
     its dtype;
  3. adam/adamax only: the coupled L2 term ``wd * p`` is added to the
     gradients of the decayed groups;
  4. the moments update and give the step ``u`` as optax computes it
     (bias correction by 1 - b**count in float32; eps 1e-6 for adamw, 1e-8
     for adam and adamax; the moments are stored in ``adam_mu_dtype`` and
     ``adam_nu_dtype`` and read in float32);
  5. each group moves by ``-lr(step) * (u + wd * p)`` (adamw decays here).

With ``gradient_accumulation_steps`` k > 1 the optimizer follows
``optax.MultiSteps``: the running mean of k micro-batch gradients, one update
every k calls.  The arithmetic is plain tensor code over lists
(``torch._foreach_*``), updating parameters and moments in place.

Placed parameters (``parallel/partition.py``: tensor parallelism over the
model axis, ``fsdp`` over the data axis) are this rank's blocks, and the
moments and the accumulator are shaped like them.  ``reduce_grads`` averages
the gradients over the data and pipe axes only (a parameter's replicas): an
``fsdp`` block's gradient arrives summed over the data ranks
(``parallel/fsdp.py``'s reduce-scatter) and is summed over the pipe ranks and
divided, a model-split leaf's is its own and is averaged over its replicas,
and a replicated leaf whose use is split by heads (VideoSwin's bias tables) is
first summed over the model axis.  The flat clip's norm is the global one: the
squares of model-split leaves summed over the model axis, of data-split
blocks over the data axis, a replicated leaf counted once.

ZeRO-1 (``zero_optimizer`` with two data ranks or more; one process, or one
data rank, is the replicated optimizer): the JAX package's placement
(``parallel/mesh.py:zero_sharded``) splits a parameter's moments and
accumulated gradient on dim 0 into one block a data rank where the leaf holds
at least 2^14 elements, dim 0 divides by the data ranks and neither tensor
parallelism nor ``fsdp`` splits it; other leaves stay whole.  ``reduce_grads``
hands a ZeRO leaf's gradient as its block; each rank updates its blocks of the
parameters and then gathers every data rank's (``parallel/collectives.py``).
``state_dict`` gathers the whole state to rank 0, which writes the
checkpoints, so a checkpoint has one layout at any mesh, and
``load_state_dict`` takes this rank's blocks of it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from valor_tpu_torch.core.config import TrainConfig
from valor_tpu_torch.core.device import torch_dtype
from valor_tpu_torch.ops.layers import Embed, LayerNorm
from valor_tpu_torch.parallel import collectives as C
from valor_tpu_torch.parallel import mesh as P
from valor_tpu_torch.parallel import partition as PT
from valor_tpu_torch.train.schedule import make_schedule

_F = np.float32


def param_group(path_str: str, new_params_name: Sequence[str]) -> str:
    """Group name of a parameter path (``/``-separated, as the JAX package's)."""
    p = path_str
    if "clip" in p and ("vision" in p or "visual" in p):
        return "clip_visual"
    if "clip" in p:
        return "clip_text"
    if "multimodal_encoder/decoder" in p:
        return "decoder"
    if any(n in p for n in new_params_name):
        return "new"
    return "basic"


def is_no_decay(path_str: str) -> bool:
    """Biases and LayerNorm scales and biases."""
    last = path_str.rsplit("/", 1)[-1]
    return last in ("bias", "scale") or last.endswith("_bias")


def is_frozen(path_str: str, frozen_vision: bool, frozen_multimodal: bool) -> bool:
    p = path_str
    if frozen_vision and ("clip_vision" in p or p.startswith("video_encoder")):
        return True
    if frozen_multimodal:
        if p.startswith("cls_head"):
            return True
        if p.startswith("multimodal_encoder") and "cross" not in p:
            return True
    return False


def flax_path(module: nn.Module, module_name: str, param_name: str) -> str:
    """The JAX package's path of a port parameter: ``models.bridge.params_from_jax``
    inverted (a LayerNorm's ``weight`` is ``scale``, an ``Embed``'s is
    ``embedding``, any other ``weight`` is a ``kernel``)."""
    leaf = param_name
    if param_name == "weight":
        if isinstance(module, LayerNorm):
            leaf = "scale"
        elif isinstance(module, Embed):
            leaf = "embedding"
        else:
            leaf = "kernel"
    return "/".join([*module_name.split("."), leaf] if module_name else [leaf])


def label_params(model: nn.Module, new_params_name: Sequence[str] = (),
                 frozen_vision: bool = False, frozen_multimodal: bool = False) -> Dict[str, str]:
    """Port parameter name -> "frozen" or "<group>_wd" / "<group>_nd"."""
    out = {}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            path = flax_path(mod, mod_name, p_name)
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            if is_frozen(path, frozen_vision, frozen_multimodal):
                out[name] = "frozen"
            else:
                out[name] = f"{param_group(path, new_params_name)}_{'nd' if is_no_decay(path) else 'wd'}"
    return out


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every element of every tensor, accumulated in float32."""
    if not tensors:
        return torch.zeros(())
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class GroupedAdam:
    """The optimizer of ``build_optimizer``; ``update(grads)`` takes one
    gradient per parameter, in ``params`` order, and returns whether the
    parameters moved (False on the first k - 1 of k accumulated calls)."""

    def __init__(self, named_params: Sequence, labels: Dict[str, str],
                 schedules: Dict[str, Callable], cfg: TrainConfig,
                 placements: Optional[Dict[str, "PT.Placement"]] = None):
        if cfg.optim not in ("adam", "adamax", "adamw"):
            raise ValueError(f"invalid optimizer {cfg.optim!r} (adam|adamax|adamw)")
        self.names = [n for n, _ in named_params]
        self.params: List[torch.Tensor] = [p for _, p in named_params]
        self.labels = [labels[n] for n in self.names]
        self.schedules = schedules
        self.optim = cfg.optim
        self.b1, self.b2 = (float(b) for b in cfg.betas)
        self.eps = 1e-6 if cfg.optim == "adamw" else 1e-8
        self.weight_decay = cfg.weight_decay
        self.max_norm = cfg.grad_norm
        self.accum = max(cfg.gradient_accumulation_steps, 1)
        self.live = [i for i, lbl in enumerate(self.labels) if lbl != "frozen"]
        placements = placements or {}
        self.place = [placements.get(n) or PT.Placement(tuple(p.shape)) for n, p in named_params]
        # ZeRO-1: the data ranks the state is split over (0: replicated, as one rank is), and which leaves split
        self.zero_world = P.data_world() if cfg.zero_optimizer and P.data_world() > 1 else 0
        self.zero_rank = P.data_rank() if self.zero_world else 0
        self.sharded = [bool(self.zero_world) and PT.zero_split(pl, self.zero_world) for pl in self.place]
        mu_dtype = torch_dtype(cfg.adam_mu_dtype) if cfg.optim != "adamax" else torch.float32
        nu_dtype = torch_dtype(cfg.adam_nu_dtype) if cfg.optim == "adamw" else torch.float32
        self.mu = [torch.zeros_like(self._mine(i, self.params[i]), dtype=mu_dtype) for i in self.live]
        self.nu = [torch.zeros_like(self._mine(i, self.params[i]), dtype=nu_dtype) for i in self.live]
        self.count = 0  # moment updates made (optax's count)
        self.mini_step = 0  # micro-batches accumulated toward the next update
        self.gradient_step = 0  # updates made (optax.MultiSteps' gradient_step)
        self.acc = ([torch.zeros_like(self._mine(i, p)) for i, p in enumerate(self.params)]
                    if self.accum > 1 else None)
        self._waits: list = []  # CUDA events the next update waits on (a checkpoint's snapshot)
        self.by_label: Dict[str, List[int]] = {}
        for j, i in enumerate(self.live):
            self.by_label.setdefault(self.labels[i], []).append(j)

    def lr(self, label: str, step: int) -> float:
        return float(self.schedules[label](step))

    def _mine(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's dim-0 block of a tensor of parameter ``i``'s shape (the
        tensor itself where the leaf is not split; a block passes through)."""
        if not self.sharded[i] or t.shape[0] != self.params[i].shape[0]:
            return t
        rows = t.shape[0] // self.zero_world
        return t.narrow(0, self.zero_rank * rows, rows)

    def _whole(self, tensors: Sequence[torch.Tensor], idx: Sequence[int]) -> List[torch.Tensor]:
        """State tensors of parameters ``idx`` as a checkpoint holds them:
        under ZeRO-1 a split leaf is gathered whole into a new tensor on data
        rank 0 (a collective) and stays this rank's block on the others; a
        placed leaf is gathered whole over both axes on rank 0 (every rank
        takes part) and stays this rank's block elsewhere; any other leaf as
        it is."""
        out, blocks, wholes = [], [], []
        first = P.rank() == 0
        for t, i in zip(tensors, idx):
            if self.sharded[i]:
                blocks.append(t)
                if self.zero_rank == 0:
                    t = t.new_empty(self.params[i].shape)
                    wholes.append(t)
            elif self.place[i].split:
                w = PT.whole(t, self.place[i])
                t = w if first else t
            out.append(t)
        if self.zero_world:
            C.gather_blocks_(blocks, wholes)
        return out

    def state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds: moments and accumulator."""
        return sum(t.numel() * t.element_size() for t in self.mu + self.nu + (self.acc or []))

    def state_dict(self) -> Dict[str, Any]:
        """Everything an exact resume needs (the counterparts of the optax
        state): the moments, the update count, ``mini_step`` and
        ``gradient_step`` of the accumulation, and its half-accumulated
        gradients ``acc`` (None without accumulation).  The tensors are the
        optimizer's own, not copies; under ZeRO-1 a split leaf is gathered
        whole into a new tensor on rank 0, the rank that writes checkpoints,
        and is this rank's block on the others (a collective: every rank
        calls it)."""
        return {
            "names": list(self.names),
            "count": self.count,
            "mini_step": self.mini_step,
            "gradient_step": self.gradient_step,
            "mu": self._whole(self.mu, self.live),
            "nu": self._whole(self.nu, self.live),
            "acc": None if self.acc is None else self._whole(self.acc, range(len(self.params))),
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy ``state`` (from ``state_dict``, on any device, whole at any
        number of ranks) into this optimizer's tensors, keeping their device
        and dtype; under ZeRO-1 this rank's blocks of the split leaves."""
        if list(state["names"]) != self.names:
            raise ValueError("optimizer state is for another parameter list")
        if (state["acc"] is None) != (self.acc is None):
            raise ValueError("optimizer state is for another gradient_accumulation_steps")
        everything = range(len(self.params))
        for mine, theirs, idx in (("mu", state["mu"], self.live), ("nu", state["nu"], self.live),
                                  ("acc", state["acc"] or [], everything)):
            dst = getattr(self, mine) or []
            if len(dst) != len(theirs):
                raise ValueError(f"optimizer state has {len(theirs)} {mine} tensors, not {len(dst)}")
            for d, t, i in zip(dst, theirs, idx):
                if tuple(t.shape) != self.place[i].shape or d.dtype != t.dtype:
                    raise ValueError(f"optimizer {mine}: {tuple(t.shape)} {t.dtype} "
                                     f"for {self.place[i].shape} {d.dtype}")
                if self.place[i].split:
                    t = PT.local(t.to(d.device), self.place[i])
                d.copy_(self._mine(i, t))
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])

    def wait_before_update(self, event) -> None:
        """The next ``update`` waits (on the device) for ``event``: a copy that
        reads the parameters or the state, which the update must not overwrite
        before it is done."""
        self._waits.append(event)

    def reduce_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every parameter's gradient averaged over its replicas, the data x
        pipe ranks of its model rank (where a process group is set): in place
        through ``all_reduce_mean_``; an ``fsdp`` block's gradient, summed over
        the data ranks already, summed over the pipe ranks and divided by both;
        a model-partial leaf's summed over the model axis first; under ZeRO-1 a
        split leaf's gradient averaged over the pipe ranks, then handed as this
        rank's block of its mean over the data ranks (``reduce_scatter_mean``).
        A fusion layer's gradient arises on its stage's pipe ranks only, the
        others giving zeros, and each stage's is over its data rank's rows
        (``parallel/pipeline.py``), so the mean over the replicas is one
        process's gradient on the global batch."""
        grads = list(grads)
        pipe = P.pipe_world() > 1
        partial = [g for g, pl in zip(grads, self.place) if pl.model_partial]
        if partial and P.model_world() > 1:
            C.all_reduce_mean_(partial, C.MODEL_AXIS, divide=1)
        fsdp = [g for g, pl in zip(grads, self.place) if pl.data_dim is not None]
        if fsdp and pipe:
            C.all_reduce_mean_(fsdp, C.PIPE_AXIS, divide=1)
        if fsdp and P.data_world() * P.pipe_world() > 1:
            torch._foreach_div_(fsdp, float(P.data_world() * P.pipe_world()))
        rest = [i for i, pl in enumerate(self.place) if pl.data_dim is None]
        C.all_reduce_mean_([grads[i] for i in rest if not self.sharded[i]])
        split = [i for i in rest if self.sharded[i]]
        if split and pipe:
            C.all_reduce_mean_([grads[i] for i in split], C.PIPE_AXIS)
        if split:
            for i, block in zip(split, C.reduce_scatter_mean([grads[i] for i in split])):
                grads[i] = block.to(grads[i].dtype)
        return grads

    def grad_norm(self, grads: Sequence[torch.Tensor], idx: Optional[Sequence[int]] = None) -> torch.Tensor:
        """The global L2 norm of the gradients of parameters ``idx`` (all when
        None), each handed as this rank's tensor: the squares of blocks split
        over the data axis (``fsdp``, ZeRO-1) summed over the data ranks, of
        leaves split over the model axis over the model ranks, a whole leaf
        counted once."""
        idx = list(range(len(grads)) if idx is None else idx)
        on_data = [j for j, i in enumerate(idx) if self.sharded[i] or self.place[i].data_dim is not None]
        on_model = [j for j, i in enumerate(idx) if self.place[i].model_dim is not None]
        if not (on_data or on_model):
            return global_norm(grads)
        norms = list(torch._foreach_norm([g.float() for g in grads]))
        split = sorted(set(on_data) | set(on_model))
        sq = {j: norms[j] * norms[j] for j in split}
        for axis, js in ((C.DATA_AXIS, on_data), (C.MODEL_AXIS, on_model)):
            if js:
                for j, v in zip(js, C.all_reduce_sum(torch.stack([sq[j] for j in js]), axis)):
                    sq[j] = v
        for j in split:
            norms[j] = sq[j].sqrt()
        return torch.linalg.vector_norm(torch.stack(norms))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        for event in self._waits:
            torch.cuda.current_stream().wait_event(event)
        self._waits = []
        grads = [self._mine(i, g) for i, g in enumerate(grads)]
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):  # Welford mean, as optax.MultiSteps
                a.add_((g.float() - a) / (n + 1))
            self.mini_step = (n + 1) % self.accum
            if self.mini_step:
                return False
            grads = self.acc
        self._inner(list(grads))
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        self.gradient_step += 1
        return True

    def _inner(self, grads: List[torch.Tensor]) -> None:
        # 1-2: frozen grads out of the norm, then the flat global-norm clip
        live_g = [grads[i] for i in self.live]
        norm = self.grad_norm(live_g, self.live)
        scale = torch.clamp(self.max_norm / norm.clamp_min(1e-9), max=1.0)
        g32 = [(g * scale).to(g.dtype).float() for g in live_g]
        params = [self._mine(i, self.params[i]) for i in self.live]
        wd = self.weight_decay
        # 3: coupled L2 for adam and adamax
        if self.optim in ("adam", "adamax") and wd:
            for lbl, idx in self.by_label.items():
                if lbl.endswith("_wd"):
                    torch._foreach_add_([g32[j] for j in idx], [params[j] for j in idx], alpha=wd)
        # 4: the moments and the step u
        self.count += 1
        c1 = float(_F(1.0) - _F(self.b1) ** _F(self.count))
        mu32 = [m.float() for m in self.mu]
        torch._foreach_mul_(mu32, self.b1)
        torch._foreach_add_(mu32, g32, alpha=1.0 - self.b1)
        nu32 = [v.float() for v in self.nu]
        if self.optim == "adamax":
            torch._foreach_mul_(nu32, self.b2)
            torch._foreach_maximum_(nu32, torch._foreach_add(torch._foreach_abs(g32), self.eps))
            u = torch._foreach_div(mu32, c1)
            torch._foreach_div_(u, nu32)
        else:
            c2 = float(_F(1.0) - _F(self.b2) ** _F(self.count))
            torch._foreach_mul_(nu32, self.b2)
            torch._foreach_addcmul_(nu32, g32, g32, value=1.0 - self.b2)
            denom = torch._foreach_div(nu32, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            u = torch._foreach_div(mu32, c1)
            torch._foreach_div_(u, denom)
        for store, full in ((self.mu, mu32), (self.nu, nu32)):
            for s, f in zip(store, full):
                if s.data_ptr() != f.data_ptr():
                    s.copy_(f)
        # 5: -lr * (u + wd * p) per group; adamw decays here
        step = self.gradient_step
        for lbl, idx in self.by_label.items():
            ps, us = [params[j] for j in idx], [u[j] for j in idx]
            if self.optim == "adamw" and wd and lbl.endswith("_wd"):
                torch._foreach_add_(us, ps, alpha=wd)
            torch._foreach_add_(ps, us, alpha=-self.lr(lbl, step))
        if self.zero_world:  # every rank's blocks of the parameters it did not update
            C.all_gather_blocks_([self.params[i] for i in self.live if self.sharded[i]])


def build_optimizer(model: nn.Module, cfg: TrainConfig, frozen_vision: bool = False,
                    frozen_multimodal: bool = False) -> GroupedAdam:
    decoder_lr = cfg.decoder_lr if cfg.decoder_lr != -1 else cfg.learning_rate
    group_lr = {
        "basic": cfg.learning_rate,
        "new": cfg.new_lr if cfg.new_lr > 0 else cfg.learning_rate,
        "clip_visual": cfg.clip_lr,
        "clip_text": cfg.clip_lr_text,
        "decoder": decoder_lr,
    }
    schedules: Dict[str, Callable] = {}
    for g, lr in group_lr.items():
        sched = make_schedule(cfg.scheduler, lr, cfg.num_train_steps, cfg.warmup_ratio)
        schedules[f"{g}_wd"] = schedules[f"{g}_nd"] = sched
    labels = label_params(model, cfg.new_params_name, frozen_vision, frozen_multimodal)
    return GroupedAdam(list(model.named_parameters()), labels, schedules, cfg, PT.placements_of(model))
