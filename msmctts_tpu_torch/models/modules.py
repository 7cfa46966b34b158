"""WaveNet-style gated residual stack and prior predictor (counterpart of
``msmctts_tpu/models/modules.py:67,138``), inference only.

Names follow the reference (``in_layers``, ``res_skip_layers``, ``enc``,
``proj``). Inputs are [B, T, C] with a [B, T, 1] validity mask; the stack
runs in NCL internally.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from msmctts_tpu_torch.ops.convs import Conv1x1, WNConv1d


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
        if gin_channels:
            raise NotImplementedError("global conditioning (gin_channels > 0) is not ported")
        C = hidden_channels
        self.hidden_channels = C
        in_layers, res_skip = [], []
        for i in range(n_layers):
            dilation = dilation_rate**i
            padding = (kernel_size * dilation - dilation) // 2
            in_layers.append(WNConv1d(C, 2 * C, kernel_size, padding=padding, dilation=dilation))
            res_skip.append(WNConv1d(C, C if i == n_layers - 1 else 2 * C, 1))
        self.in_layers = nn.ModuleList(in_layers)
        self.res_skip_layers = nn.ModuleList(res_skip)

    def forward(self, x, mask):
        C = self.hidden_channels
        x = x.transpose(1, 2)
        mask = mask.transpose(1, 2)
        output = torch.zeros_like(x)
        last = len(self.in_layers) - 1
        for i, (conv_in, conv_rs) in enumerate(zip(self.in_layers, self.res_skip_layers)):
            x_in = conv_in(x)
            acts = torch.tanh(x_in[:, :C]) * torch.sigmoid(x_in[:, C:])
            res_skip = conv_rs(acts)
            if i < last:
                x = (x + res_skip[:, :C]) * mask
                output = output + res_skip[:, C:]
            else:
                output = output + res_skip
        return (output * mask).transpose(1, 2)


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
