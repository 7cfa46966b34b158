"""Dropout that draws from an explicit generator.

The JAX package threads a ``dropout`` PRNG key through every training
forward; here every :class:`Dropout` under a model draws from one
``torch.Generator`` that the trainer owns and binds with
:func:`bind_generator`, on the step's device. Nothing draws from the global
RNG, so a run's noise depends only on the trainer's seed. In ``eval()`` mode,
or at rate 0, the module is the identity and needs no generator.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class Dropout(nn.Module):
    """Inverted dropout: keep with probability ``1 - rate``, scale kept
    values by ``1 / (1 - rate)``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate <= 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in training mode needs a generator: call bind_generator(model, generator) first")
        keep = 1.0 - self.rate
        mask = torch.empty(x.shape, dtype=x.dtype, device=x.device).bernoulli_(keep, generator=self.generator)
        return x * mask / keep

    def extra_repr(self):
        return f"rate={self.rate}"


def bind_generator(module: nn.Module, generator: Optional[torch.Generator]):
    """Make every :class:`Dropout` under ``module`` draw from ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
