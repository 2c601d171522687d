"""Plain reference of VALOR's optimizer step: grouped AdamW behind a flat clip.

The step, as the VALOR recipe states it and the JAX package computes it:
every gradient scaled by min(1, grad_norm / its global L2 norm); then AdamW
(optax's: bias correction by 1 - b**count in float32, eps 1e-6 outside the
root) with the decoupled decay ``wd * p`` on the decayed groups; each group's
rate from the triangular schedule (linear warm-up over ``warmup_ratio`` of
``num_train_steps``, then linear decay), where x = (step + 1) / steps.  The
groups: CLIP's vision side (``clip_lr``), CLIP's text side (``clip_lr_text``),
everything else (``learning_rate``); no decay for biases and LayerNorm
scales.  Plain fp32 tensor code, one parameter at a time.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_F = np.float32


def group(name: str, is_layernorm: bool) -> str:
    path = name.replace(".", "/")
    if "clip" in path and ("vision" in path or "visual" in path):
        g = "clip_visual"
    elif "clip" in path:
        g = "clip_text"
    else:
        g = "basic"
    last = path.rsplit("/", 1)[-1]
    no_decay = last == "bias" or last.endswith("_bias") or (is_layernorm and last == "weight")
    return g + ("_nd" if no_decay else "_wd")


def rate(base: float, step: int, steps: int, warmup_ratio: float) -> float:
    x = (_F(step) + _F(1.0)) / _F(max(steps, 1))
    if x < _F(warmup_ratio):
        ratio = x / _F(warmup_ratio)
    else:
        ratio = max((x - _F(1.0)) / (_F(warmup_ratio) - _F(1.0)), _F(0.0))
    return float(_F(base) * _F(ratio))


class AdamW:
    def __init__(self, named: Dict[str, torch.Tensor], groups: Dict[str, str], train: dict):
        self.names = list(named)
        self.params = named
        self.groups = groups
        self.b1, self.b2 = (float(b) for b in train.get("betas", (0.9, 0.98)))
        self.wd = float(train.get("weight_decay", 0.01))
        self.max_norm = float(train.get("grad_norm", 2.0))
        self.steps = int(train["num_train_steps"])
        self.warmup = float(train.get("warmup_ratio", 0.1))
        self.lr = {"basic": float(train.get("learning_rate", 1e-4)),
                   "clip_visual": float(train.get("clip_lr", 5e-7)),
                   "clip_text": float(train.get("clip_lr_text", 5e-7))}
        self.mu = {n: torch.zeros_like(p) for n, p in named.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in named.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Apply one update; returns the clipped gradients (the optimizer's input)."""
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(grads[n]) for n in self.names]))
        scale = torch.clamp(self.max_norm / norm.clamp_min(1e-9), max=1.0)
        clipped = {n: grads[n] * scale for n in self.names}
        step = self.count
        self.count += 1
        c1 = float(_F(1.0) - _F(self.b1) ** _F(self.count))
        c2 = float(_F(1.0) - _F(self.b2) ** _F(self.count))
        for n in self.names:
            g, p = clipped[n], self.params[n]
            self.mu[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (self.mu[n] / c1) / ((self.nu[n] / c2).sqrt() + 1e-6)
            grp = self.groups[n]
            if grp.endswith("_wd"):
                u = u + self.wd * p
            p.add_(u, alpha=-rate(self.lr[grp[:-3]], step, self.steps, self.warmup))
        return clipped

