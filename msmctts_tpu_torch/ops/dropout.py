"""Dropout that draws from an explicit generator.

The JAX package threads a ``dropout`` PRNG key through every training
forward; here every :class:`Dropout` under a model draws from one
``torch.Generator`` that the trainer owns and binds with
:func:`bind_generator`, on the step's device. Nothing draws from the global
RNG, so a run's noise depends only on the trainer's seed. In ``eval()`` mode,
or at rate 0, the module is the identity and needs no generator.

Under data parallelism a step's noise must not depend on how the batch is
split. The JAX package draws one mask for the global batch from one key;
here every rank's generator holds the same state, every rank draws the mask
of the *global* batch (``world`` times its own rows; the batch is the
leading dimension at every call site) and keeps its own block of rows. W
ranks then apply the mask one rank would, and the generator's state stays
one state for the whole run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn


class Dropout(nn.Module):
    """Inverted dropout: keep with probability ``1 - rate``, scale kept
    values by ``1 / (1 - rate)``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None
        self.shard: Tuple[int, int] = (0, 1)  # (rank, world) of the batch rows this process holds

    def forward(self, x):
        if not self.training or self.rate <= 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in training mode needs a generator: call bind_generator(model, generator) first")
        keep = 1.0 - self.rate
        rank, world = self.shard
        B = x.shape[0]
        mask = torch.empty((B * world, *x.shape[1:]), dtype=x.dtype, device=x.device).bernoulli_(keep, generator=self.generator)
        return x * mask[rank * B : (rank + 1) * B] / keep

    def extra_repr(self):
        return f"rate={self.rate}"


def bind_generator(module: nn.Module, generator: Optional[torch.Generator], shard: Tuple[int, int] = (0, 1)):
    """Make every :class:`Dropout` under ``module`` draw from ``generator``,
    as rank ``shard[0]`` of ``shard[1]`` equal blocks of the global batch,
    and every other module that says ``binds_generator`` (an
    ``EMAQuantizer``'s codeword restarts, which take their rank from their
    group) draw from it too."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
            m.shard = shard
        elif getattr(m, "binds_generator", False):
            m.generator = generator
