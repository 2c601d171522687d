"""Process logger and metric meter of the PyTorch port (its copy of the parts
of ``valor_tpu.core.logging`` it uses: ``LOGGER`` and ``RunningMeter``)."""

from __future__ import annotations

import logging
import math
from typing import Optional

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"

logging.basicConfig(format=_LOG_FMT, datefmt=_DATE_FMT, level=logging.INFO)
LOGGER = logging.getLogger("valor_tpu_torch")


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
