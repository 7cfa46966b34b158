"""Weight-normalized convolutions (counterpart of ``msmctts_tpu/ops/convs.py``).

Parameters keep torch's ``weight_norm`` names and layouts: ``weight_v``
[out, in, k] and ``weight_g`` [out, 1, 1] for a conv; ``weight_v``
[in, out, k] and ``weight_g`` [in, 1, 1] for a transposed conv, whose norm
is therefore per *input* channel (the JAX package's axes (0, 2) on its
[k, in, out] layout, ``msmctts_tpu/ops/convs.py:126``). Both norms run over
every axis but the first.

In ``train()`` mode the kernel ``v / max(||v||, 1e-12) * g`` (the JAX
formula, ``convs.py:30-40``) is computed in the graph at every forward, so
``weight_v`` and ``weight_g`` get gradients. In ``eval()`` mode each module
uses a folded copy in a non-persistent ``weight`` buffer, made at
construction, after every ``load_state_dict`` and on every switch to eval
(so a fold made before an optimizer step is never used after it). Code that
writes ``weight_v``/``weight_g`` in place while in eval mode calls
:func:`refold` afterwards.

The conv modules take torch's NCL / NCHW layout. ``hifigan_init`` marks the
convs the JAX package draws from N(0, 0.01) (``weights.init_random`` reads
it); the others are lecun-normal there. ``Conv1x1`` is the 1x1 conv the
reference uses on [B, C, T]; here it maps [B, T, C] directly.

Dtypes follow the JAX package under ``precision: bfloat16``
(``parallel/precision.py``): the kernel is folded in fp32 from whatever
dtype ``weight_v`` and ``weight_g`` hold and cast to the input's dtype, and
the bias to the output's (``msmctts_tpu/ops/convs.py:31-34,89,97,137,145``);
``Conv1x1`` is a ``flax.linen.Dense`` there, so input, weight and bias take
their promoted dtype.

A row-parallel conv of tensor parallelism (``parallel/sharding.py``) holds
its rank's input channels of ``weight_v``; with ``norm_group`` set, its
per-output-channel norm in training is taken over every shard (the squared
norm all-reduced over the group in the graph, with its gradient) and its
replicated ``g`` gets the gradient summed over the shards. Folding a shard
for eval is refused.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from msmctts_tpu_torch.parallel.sharding import copy_to_model, sum_over_model


def _to(t, dtype):
    return None if t is None else t.to(dtype)


def fold_weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Dense kernel ``v / max(||v||, 1e-12) * g``, norm over all axes but 0,
    in fp32 whatever the dtype of ``v`` and ``g`` (``msmctts_tpu/ops/convs.py:31-34``)."""
    v, g = v.float(), g.float()
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))
    return v / torch.clamp(norm, min=1e-12) * g


class _Folded(nn.Module):
    """A weight-norm pair: live in training, folded for eval."""

    hifigan_init = False
    norm_group = None  # the model group while its input channels are split

    def _init_pair(self, shape, bias_size, bias: bool, hifigan_init: bool):
        self.hifigan_init = hifigan_init
        self.weight_v = nn.Parameter(torch.empty(*shape))
        nn.init.normal_(self.weight_v, std=0.01)
        norm_dims = tuple(range(1, len(shape)))
        self.weight_g = nn.Parameter(
            torch.sqrt(torch.sum(self.weight_v.detach() ** 2, dim=norm_dims, keepdim=True))
        )
        self.bias = nn.Parameter(torch.zeros(bias_size)) if bias else None
        self.register_buffer("weight", None, persistent=False)
        self.register_load_state_dict_post_hook(lambda module, _keys: module.fold())
        self.fold()

    @torch.no_grad()
    def fold(self):
        if self.norm_group is not None:
            raise RuntimeError("a weight-norm conv split over its input channels folds only when gathered")
        self.weight = fold_weight_norm(self.weight_v, self.weight_g)

    def train(self, mode: bool = True):
        super().train(mode)
        if not mode:
            self.fold()
        return self

    def kernel(self):
        """The dense kernel of this forward: in the graph when training."""
        if self.training and self.norm_group is not None:
            v = self.weight_v.float()
            sq = sum_over_model(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True), self.norm_group)
            return v / torch.clamp(torch.sqrt(sq), min=1e-12) * copy_to_model(self.weight_g.float(), self.norm_group)
        if self.training:
            return fold_weight_norm(self.weight_v, self.weight_g)
        return self.weight


class WNConv1d(_Folded):
    """Weight-normalized ``Conv1d`` over [B, C, T]."""

    def __init__(self, in_channels, out_channels, kernel_size, padding=0, dilation=1, bias=True,
                 hifigan_init=False):
        super().__init__()
        self.padding = padding
        self.dilation = dilation
        self._init_pair((out_channels, in_channels, kernel_size), out_channels, bias, hifigan_init)

    def forward(self, x):
        return F.conv1d(x, self.kernel().to(x.dtype), _to(self.bias, x.dtype), padding=self.padding,
                        dilation=self.dilation)


class WNConv2d(_Folded):
    """Weight-normalized ``Conv2d`` over [B, C, H, W] (the discriminators'
    conv; ``msmctts_tpu/ops/convs.py:43-98`` with two spatial dims)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, bias=True):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self._init_pair((out_channels, in_channels, *kernel_size), out_channels, bias, False)

    def forward(self, x):
        return F.conv2d(x, self.kernel().to(x.dtype), _to(self.bias, x.dtype), stride=self.stride,
                        padding=self.padding)


class WNConvTranspose1d(_Folded):
    """Weight-normalized ``ConvTranspose1d`` over [B, C, T]; output length
    ``(L - 1) * stride - 2 * padding + kernel_size`` (``convs.py:101-146``)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, padding, bias=True,
                 hifigan_init=False):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self._init_pair((in_channels, out_channels, kernel_size), out_channels, bias, hifigan_init)

    def forward(self, x):
        return F.conv_transpose1d(x, self.kernel().to(x.dtype), _to(self.bias, x.dtype), stride=self.stride,
                                  padding=self.padding)


class Conv1x1(nn.Module):
    """1x1 ``Conv1d`` (weight [out, in, 1]) applied to [B, T, in]."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1))
        nn.init.normal_(self.weight, std=in_channels ** -0.5)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        dt = torch.promote_types(torch.promote_types(x.dtype, self.weight.dtype), self.bias.dtype)
        return F.linear(x.to(dt), self.weight[:, :, 0].to(dt), self.bias.to(dt))


def refold(module: nn.Module):
    """Re-fold every weight-norm pair under ``module``, children first."""
    for m in reversed(list(module.modules())):
        if hasattr(m, "fold"):
            m.fold()
