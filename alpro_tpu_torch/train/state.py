"""Train state: step counter, the model (which owns its parameters) and the
optimizer state (counterpart of ``alpro_tpu/train/state.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any

from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: Any

    @classmethod
    def create(cls, model: nn.Module, optimizer) -> "TrainState":
        """Step 0 and ``optimizer.init`` over ``model.named_parameters()``,
        whose order every update follows."""
        return cls(step=0, model=model, opt_state=optimizer.init(dict(model.named_parameters())))
