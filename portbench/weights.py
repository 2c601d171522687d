"""The benchmark's weights: drawn from the seed on the device, in a few large calls.

Every parameter of VALOR is drawn by the benchmark's own law, named by
``reference.model.parameter_kinds``: LayerNorm scales 1, biases 0, CLIP's
``logit_scale`` log(1/0.07) and ``contra_temp`` 0.07, every matrix and patch
convolution N(0, 1/fan_in) (activations stay at unit scale, so attention is
sharp and a caption depends on its media), every embedding N(0, 0.02).  The
normal draws come from one ``torch.Generator`` on the card, one call for each
standard deviation, in fp32, the type the program keeps its parameters in.
The same seed gives the same tensors, which load by name into the program and
into the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.reference.model import ReferenceVALOR, fan_in, parameter_kinds


def shapes(cfg: dict) -> Tuple[Dict[str, tuple], Dict[str, str]]:
    """(name -> shape, name -> kind) of every parameter."""
    with torch.device("meta"):
        model = ReferenceVALOR(cfg)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}, parameter_kinds(model)


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> fp32 tensor on ``device``."""
    sizes, kinds = shapes(cfg)
    out: Dict[str, torch.Tensor] = {}
    normal: Dict[float, list] = {}
    for name, shape in sizes.items():
        kind = kinds[name]
        if kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "logit_scale":
            out[name] = torch.full(shape, math.log(1 / 0.07), device=device)
        elif kind == "temp":
            out[name] = torch.full(shape, 0.07, device=device)
        else:
            std = fan_in(name, shape) ** -0.5 if kind == "fan_in" else 0.02
            normal.setdefault(std, []).append(name)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    for std in sorted(normal):
        names = normal[std]
        counts = [math.prod(sizes[n]) for n in names]
        flat = torch.randn(sum(counts), generator=gen, device=device).mul_(std)
        for name, part in zip(names, torch.split(flat, counts)):
            out[name] = part.view(sizes[name])
    return out
