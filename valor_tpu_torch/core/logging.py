"""Logging, metric meters and TensorBoard scalars of the PyTorch port (its copy of
``valor_tpu.core.logging``).

  * ``LOGGER``, with an optional file handler (``add_log_to_file``);
  * ``is_main_process``: rank 0 of the data-parallel group, which alone writes
    the run's files;
  * ``RunningMeter``, an EMA meter (smooth 0.99) that skips NaN and inf;
  * ``TB_LOGGER``, a TensorBoard writer with an internal global step that is a
    silent no-op when neither tensorboardX nor ``torch.utils.tensorboard``
    imports.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, Optional

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"

logging.basicConfig(format=_LOG_FMT, datefmt=_DATE_FMT, level=logging.INFO)
LOGGER = logging.getLogger("valor_tpu_torch")
LOGGER.setLevel(logging.INFO)  # whatever level the root logger was given before


def add_log_to_file(log_path: str) -> None:
    """Also write LOGGER's records to ``log_path`` (once per path)."""
    path = os.path.abspath(log_path)
    if any(getattr(h, "baseFilename", None) == path for h in LOGGER.handlers):
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter(_LOG_FMT, datefmt=_DATE_FMT))
    LOGGER.addHandler(fh)


def is_main_process() -> bool:
    """Rank 0 of the process group, or the one process where there is none
    (the JAX package's ``jax.process_index() == 0``)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class RunningMeter:
    """Exponential-moving-average meter (smooth 0.99); NaN and inf readings are skipped."""

    def __init__(self, name: str, val: Optional[float] = None, smooth: float = 0.99):
        self._name = name
        self._sm = smooth
        self._val = val

    def __call__(self, value: float) -> None:
        value = float(value)
        if math.isnan(value) or math.isinf(value):
            return
        self._val = value if self._val is None else self._val * self._sm + value * (1 - self._sm)

    @property
    def val(self) -> Optional[float]:
        return self._val

    @property
    def name(self) -> str:
        return self._name

    def __str__(self) -> str:
        return f"{self._name}: {self._val:.4f}" if self._val is not None else f"{self._name}: n/a"


class TensorboardLogger:
    """Global-step-tracking TensorBoard wrapper (reference: utils/logger.py:27-69)."""

    def __init__(self) -> None:
        self._writer = None
        self._global_step = 0

    def create(self, path: str) -> None:
        """Write scalars under ``path`` from now on (closing an earlier writer)."""
        self.close()
        try:
            from tensorboardX import SummaryWriter  # type: ignore
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter  # type: ignore
            except ImportError:
                LOGGER.debug("tensorboard unavailable; scalar logging disabled")
                return
        self._writer = SummaryWriter(path)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def set_step(self, step: int) -> None:
        self._global_step = step

    @property
    def global_step(self) -> int:
        return self._global_step

    def add_scalar(self, tag: str, value: float, step: Optional[int] = None) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step if step is not None else self._global_step)

    def log_scalar_dict(self, d: Dict[str, float], prefix: str = "") -> None:
        for k, v in d.items():
            self.add_scalar(f"{prefix}{k}", float(v))


TB_LOGGER = TensorboardLogger()
