"""WaveNet-style gated residual stack, prior predictor, the v1 encoder and
torch's affine-free batch norm (counterpart of
``msmctts_tpu/models/modules.py``).

Names follow the reference (``in_layers``, ``res_skip_layers``,
``cond_layer``, ``enc``, ``pre``, ``proj``; ``running_mean`` /
``running_var``). Inputs are [B, T, C] with a [B, T, 1] validity mask; the
stack runs in NCL internally.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from msmctts_tpu_torch.ops.convs import Conv1x1, WNConv1d
from msmctts_tpu_torch.ops.dropout import Dropout
from msmctts_tpu_torch.parallel.mesh import sum_over_ranks


class TorchBatchNorm(nn.Module):
    """``nn.BatchNorm1d(C, eps=1e-5, affine=False)`` over [..., C] as the JAX
    package computes it (``msmctts_tpu/models/modules.py:20-64``), the
    quantizer preprocessor's ``norm: True``. In ``train()`` mode it
    normalizes with the batch's mean and *biased* variance over every frame
    (padded ones too: no mask, as in JAX) and moves the running statistics
    with torch's momentum 0.1 and the Bessel-corrected variance; ``eval()``
    normalizes with the running statistics. Under a process group
    (``group``) the statistics are the global batch's: the sums, then the
    sums of squared deviations, each summed over the ranks through the
    differentiable all-reduce, so W ranks normalize and update as one."""

    momentum = 0.1
    eps = 1e-5

    def __init__(self, channels: int):
        super().__init__()
        self.group = None  # parallel.mesh.Group of a data-parallel trainer
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        xf = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            C = x.shape[-1]
            flat = xf.reshape(-1, C)
            count = torch.full((1,), float(flat.shape[0]), device=x.device)
            sums = sum_over_ranks(torch.cat([flat.sum(dim=0), count]), self.group)
            n = sums[C]
            mean = sums[:C] / n
            var = sum_over_ranks(torch.square(flat - mean).sum(dim=0), self.group) / n
            with torch.no_grad():
                bessel = n / torch.clamp(n - 1.0, min=1.0)
                self.running_mean.copy_((1 - self.momentum) * self.running_mean + self.momentum * mean)
                self.running_var.copy_((1 - self.momentum) * self.running_var + self.momentum * var * bessel)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class ResStack(nn.Module):
    """Non-causal gated conv stack with residual/skip split."""

    def __init__(
        self,
        hidden_channels: int,
        kernel_size: int,
        dilation_rate: int,
        n_layers: int,
        gin_channels: int = 0,
        p_dropout: float = 0.1,
    ):
        super().__init__()
        C = hidden_channels
        self.hidden_channels = C
        self.drop = Dropout(p_dropout)
        in_layers, res_skip = [], []
        for i in range(n_layers):
            dilation = dilation_rate**i
            padding = (kernel_size * dilation - dilation) // 2
            in_layers.append(WNConv1d(C, 2 * C, kernel_size, padding=padding, dilation=dilation))
            res_skip.append(WNConv1d(C, C if i == n_layers - 1 else 2 * C, 1))
        self.in_layers = nn.ModuleList(in_layers)
        self.res_skip_layers = nn.ModuleList(res_skip)
        # global conditioning: one 1x1 conv to every layer's 2C gate inputs
        self.cond_layer = WNConv1d(gin_channels, 2 * C * n_layers, 1) if gin_channels else None

    def forward(self, x, mask, g=None):
        """x [B, T, C], mask [B, T, 1]; ``g`` [B, 1, gin_channels] is added
        to every layer's gate inputs through ``cond_layer``
        (``msmctts_tpu/models/modules.py:67-111``)."""
        C = self.hidden_channels
        x = x.transpose(1, 2)
        mask = mask.transpose(1, 2)
        output = torch.zeros_like(x)
        g_all = None if g is None else self.cond_layer(g.transpose(1, 2))  # [B, 2 C n_layers, 1]
        last = len(self.in_layers) - 1
        for i, (conv_in, conv_rs) in enumerate(zip(self.in_layers, self.res_skip_layers)):
            x_in = conv_in(x)
            if g_all is not None:
                x_in = x_in + g_all[:, i * 2 * C : (i + 1) * 2 * C]
            acts = self.drop(torch.tanh(x_in[:, :C]) * torch.sigmoid(x_in[:, C:]))
            res_skip = conv_rs(acts)
            if i < last:
                x = (x + res_skip[:, :C]) * mask
                output = output + res_skip[:, C:]
            else:
                output = output + res_skip
        return (output * mask).transpose(1, 2)


class Encoder(nn.Module):
    """1x1 ``pre`` -> ResStack ``enc`` -> 1x1 ``proj``, masked (reference
    vqgantts/modules.py:262-289; ``msmctts_tpu/models/modules.py:113-135``)."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int, kernel_size: int = 5,
                 dilation_rate: int = 1, n_layers: int = 4):
        super().__init__()
        self.pre = Conv1x1(in_channels, hidden_channels)
        self.enc = ResStack(hidden_channels, kernel_size, dilation_rate, n_layers)
        self.proj = Conv1x1(hidden_channels, out_channels)

    def forward(self, x, mask):
        h = self.enc(self.pre(x) * mask, mask)
        return self.proj(h) * mask


class PriorPredictor(nn.Module):
    """ResStack + 1x1 projection predicting the next stage's
    pre-quantization embedding from the running residual
    (msmc_vqgan.py:65-88). Returns (hidden, projection)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 5,
        dilation_rate: int = 1,
        n_layers: int = 4,
        p_dropout: float = 0.1,
    ):
        super().__init__()
        self.enc = ResStack(in_channels, kernel_size, dilation_rate, n_layers, p_dropout=p_dropout)
        self.proj = Conv1x1(in_channels, out_channels)

    def forward(self, x, mask):
        h = self.enc(x, mask)
        return h, self.proj(h) * mask
