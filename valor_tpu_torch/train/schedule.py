"""Learning-rate ratio schedules (counterpart of ``valor_tpu/train/schedule.py``).

Each group's rate at optimizer update ``step`` (0-based) is
``init_lr * ratio(x)`` with x = (step + 1) / num_train_steps: the reference
bumps its global step before it sets the rate, so the first update already
sees step 1.  Computed in float32, as the JAX schedules are.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def warmup_linear(x, warmup_ratio):
    """Triangular: ramp to 1 at warmup, then linear decay to 0 at x = 1."""
    if x < _F(warmup_ratio):
        return x / _F(warmup_ratio)
    return max((x - _F(1.0)) / (_F(warmup_ratio) - _F(1.0)), _F(0.0))


def warmup_cosine(x, warmup_ratio):
    if x < _F(warmup_ratio):
        return x / _F(warmup_ratio)
    return _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * x))


def warmup_constant(x, warmup_ratio):
    return x / _F(warmup_ratio) if x < _F(warmup_ratio) else _F(1.0)


_SCHEDULES = {
    "warmup_linear": warmup_linear,
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
}


def make_schedule(name: str, init_lr: float, num_train_steps: int, warmup_ratio: float):
    """step -> learning rate (a float32 scalar)."""
    fn = _SCHEDULES[name]
    denom = _F(max(num_train_steps, 1))

    def schedule(step: int):
        x = (_F(step) + _F(1.0)) / denom
        return _F(init_lr) * _F(fn(x, warmup_ratio))

    return schedule
