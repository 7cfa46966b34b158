"""Weight-normalized convolutions (counterpart of ``msmctts_tpu/ops/convs.py``).

Parameters keep torch's ``weight_norm`` names and layouts: ``weight_v``
[out, in, k] and ``weight_g`` [out, 1, 1] for a conv; ``weight_v``
[in, out, k] and ``weight_g`` [in, 1, 1] for a transposed conv, whose norm
is therefore per *input* channel (the JAX package's axes (0, 2) on its
[k, in, out] layout, ``msmctts_tpu/ops/convs.py:126``). Both norms run over
every axis but the first.

Inference needs no live weight norm: each module folds
``v / max(||v||, 1e-12) * g`` (the JAX formula, ``convs.py:30-40``) into a
non-persistent ``weight`` buffer at construction and again after every
``load_state_dict``. Code that writes ``weight_v``/``weight_g`` in place
calls :func:`refold` afterwards.

The conv modules take torch's NCL layout. ``Conv1x1`` is the 1x1 conv the
reference uses on [B, C, T]; here it maps [B, T, C] directly.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def fold_weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Dense kernel ``v / max(||v||, 1e-12) * g``, norm over all axes but 0."""
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))
    return v / torch.clamp(norm, min=1e-12) * g


class _Folded(nn.Module):
    """Keeps a folded copy of a weight-norm pair in sync with loads."""

    def _init_fold(self):
        self.register_buffer("weight", None, persistent=False)
        self.register_load_state_dict_post_hook(lambda module, _keys: module.fold())
        self.fold()

    @torch.no_grad()
    def fold(self):
        self.weight = fold_weight_norm(self.weight_v, self.weight_g)


class WNConv1d(_Folded):
    """Weight-normalized ``Conv1d`` over [B, C, T]."""

    def __init__(self, in_channels, out_channels, kernel_size, padding=0, dilation=1, bias=True):
        super().__init__()
        self.padding = padding
        self.dilation = dilation
        self.weight_v = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        nn.init.normal_(self.weight_v, std=0.01)
        self.weight_g = nn.Parameter(
            torch.sqrt(torch.sum(self.weight_v.detach() ** 2, dim=(1, 2), keepdim=True))
        )
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self._init_fold()

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, padding=self.padding, dilation=self.dilation)


class WNConvTranspose1d(_Folded):
    """Weight-normalized ``ConvTranspose1d`` over [B, C, T]; output length
    ``(L - 1) * stride - 2 * padding + kernel_size`` (``convs.py:101-146``)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, padding, bias=True):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.weight_v = nn.Parameter(torch.empty(in_channels, out_channels, kernel_size))
        nn.init.normal_(self.weight_v, std=0.01)
        self.weight_g = nn.Parameter(
            torch.sqrt(torch.sum(self.weight_v.detach() ** 2, dim=(1, 2), keepdim=True))
        )
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self._init_fold()

    def forward(self, x):
        return F.conv_transpose1d(
            x, self.weight, self.bias, stride=self.stride, padding=self.padding
        )


class Conv1x1(nn.Module):
    """1x1 ``Conv1d`` (weight [out, in, 1]) applied to [B, T, in]."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1))
        nn.init.normal_(self.weight, std=in_channels ** -0.5)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        return F.linear(x, self.weight[:, :, 0], self.bias)


def refold(module: nn.Module):
    """Re-fold every weight-norm pair under ``module``, children first."""
    for m in reversed(list(module.modules())):
        if hasattr(m, "fold"):
            m.fold()
