"""Mixed precision: bf16 compute over fp32 masters (counterpart of
``msmctts_tpu/parallel/precision.py``, config key ``precision``).

The JAX policy casts the ``params`` collection, and in the trainers the
float inputs, to bf16; every later op takes the dtype JAX's type promotion
gives it. Codebooks and BatchNorm statistics are not ``params`` there and
stay fp32, and so do the paths that cast to fp32 on purpose: the VQ search
and its EMA statistics, the commitment term, the STFT and every loss, the
weight-norm direction. A bf16 activation that meets an fp32 array (a mask,
the sinusoid position table) promotes back to fp32, so the policy rounds
the weights to bf16 far more often than it computes in bf16.

The port reproduces that policy, not a faster one:

  * master parameters stay fp32 parameters of the module; inside a train
    step :func:`functional` runs the module through
    ``torch.func.functional_call`` on ``p.to(dtype)`` of its float
    parameters. ``.to`` is differentiable, so the backward adds fp32
    gradients onto the masters, as the transpose of ``cast_floats`` does
    inside ``jax.vjp``; buffers (codebooks, their EMA counts, BatchNorm
    running statistics, folded-weight caches) are left as they are;
  * the inference task rounds its parameters once, at load
    (:func:`cast_parameters_`): they then hold bf16 values in a bf16
    dtype, as the JAX task's ``_cast`` leaves its ``params``, and every
    weight-norm cache is refolded from them;
  * torch does not promote the operands of ``F.linear``, ``F.conv1d`` or
    ``F.layer_norm`` as ``flax.linen.Dense`` / ``Conv`` / ``LayerNorm``
    do, so the port's layers do it themselves: :class:`Linear` and
    :class:`Conv1d` cast input, weight and bias to their promoted dtype,
    :class:`LayerNorm` normalizes in fp32 and returns that dtype. Under
    fp32 every one of them is the plain torch layer.

``torch.autocast`` is not used: its per-op dtype lists are not JAX's (it
keeps a residual add or a LayerNorm output in fp32 where JAX keeps bf16).
"""

from __future__ import annotations

from functools import reduce
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from msmctts_tpu_torch.ops.convs import refold

_NAMES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "fp32": torch.float32, "float32": torch.float32}


def compute_dtype(config) -> torch.dtype:
    """The config's ``precision`` (default ``float32``) as a torch dtype;
    an unknown name raises ``ValueError``, as the JAX package's does."""
    name = str(config.get("precision", "float32")).lower()
    if name not in _NAMES:
        raise ValueError(f"unknown precision '{name}'")
    return _NAMES[name]


def cast_floats(tree, dtype: torch.dtype):
    """Float tensors of a tensor, or of a dict / list / tuple of them, cast
    to ``dtype``; integer and bool tensors, and everything else, untouched."""
    if dtype == torch.float32:
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return tree


def functional(module: nn.Module, dtype: torch.dtype):
    """``module``'s forward on its float parameters cast to ``dtype``
    (the module itself under fp32). The casts are made here, once, in the
    autograd graph of the masters (or outside any graph where the masters
    take no gradient), and every call of the result shares them."""
    if dtype == torch.float32:
        return module
    params = {k: (p.to(dtype) if p.is_floating_point() else p) for k, p in module.named_parameters()}

    def call(*args, **kwargs):
        return torch.func.functional_call(module, params, args, kwargs, strict=False)

    return call


@torch.no_grad()
def cast_parameters_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store every float parameter of ``module`` in ``dtype`` (in place;
    buffers untouched) and refold its weight-norm caches from the rounded
    values. A later ``load_state_dict`` copies into the cast parameters, so
    loaded weights are rounded as they arrive."""
    if dtype != torch.float32:
        for p in module.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)
        refold(module)
    return module


def result_dtype(*tensors: Optional[torch.Tensor]) -> torch.dtype:
    """The dtype JAX's promotion gives an op over these arrays (None skipped)."""
    return reduce(torch.promote_types, (t.dtype for t in tensors if t is not None))


def _to(t: Optional[torch.Tensor], dtype: torch.dtype):
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` with ``flax.linen.Dense``'s dtype rule: input, weight
    and bias cast to their promoted dtype."""

    def forward(self, x):
        dt = result_dtype(x, self.weight, self.bias)
        return F.linear(x.to(dt), self.weight.to(dt), _to(self.bias, dt))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` with ``flax.linen.Conv``'s dtype rule (as :class:`Linear`)."""

    def forward(self, x):
        dt = result_dtype(x, self.weight, self.bias)
        return self._conv_forward(x.to(dt), self.weight.to(dt), _to(self.bias, dt))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` as ``flax.linen.LayerNorm`` computes it: statistics,
    normalization and the affine step in fp32, the result in the promoted
    dtype of input, scale and bias."""

    def forward(self, x):
        w, b = self.weight, self.bias
        out = F.layer_norm(x.float(), self.normalized_shape, _to(w, torch.float32), _to(b, torch.float32), self.eps)
        return out.to(result_dtype(x, w, b))
