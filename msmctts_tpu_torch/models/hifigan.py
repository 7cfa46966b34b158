"""HiFi-GAN generator (counterpart of ``msmctts_tpu/models/hifigan.py``),
inference only.

Every ResBlock1 dilation layer runs through ``ops/resblock.py`` (kernel 2
on the card): 4 stages x 3 blocks x 3 dilations = 36 launches per CSMSC
decode. The upsampling transposed convs and the pre/post convs stay plain
PyTorch convs, as the JAX package leaves them to XLA. Names follow the
reference (``conv_pre``, ``ups.i``, ``resblocks.r.convs1.m``, ``conv_post``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from msmctts_tpu_torch.ops.convs import WNConv1d, WNConvTranspose1d, fold_weight_norm
from msmctts_tpu_torch.ops.resblock import LRELU_SLOPE, fused_resblock_layer
from msmctts_tpu_torch.registry import register_network


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class ResBlock1(nn.Module):
    """MRF residual block (hifigan/common.py:21-58) over [B, T, C]; each
    dilation layer is one ``fused_resblock_layer`` call. The folded weights
    are also kept tap-major [k, C_in, C_out], the layout the kernel reads,
    refreshed after every load."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, _get_padding(kernel_size, d), d)
            for d in self.dilations
        )
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, _get_padding(kernel_size, 1))
            for _ in self.dilations
        )
        for i in range(len(self.dilations)):
            self.register_buffer(f"taps1_{i}", None, persistent=False)
            self.register_buffer(f"taps2_{i}", None, persistent=False)
        self.register_load_state_dict_post_hook(lambda module, _keys: module.fold())
        self.fold()

    @torch.no_grad()
    def fold(self):
        for i, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            setattr(self, f"taps1_{i}", fold_weight_norm(c1.weight_v, c1.weight_g).permute(2, 1, 0).contiguous())
            setattr(self, f"taps2_{i}", fold_weight_norm(c2.weight_v, c2.weight_g).permute(2, 1, 0).contiguous())

    def forward(self, x):
        for i, d in enumerate(self.dilations):
            x = fused_resblock_layer(
                x, getattr(self, f"taps1_{i}"), self.convs1[i].bias,
                getattr(self, f"taps2_{i}"), self.convs2[i].bias, d,
            )
        return x


class ResBlock2(nn.Module):
    """Single-conv residual block (hifigan/common.py) over [B, T, C], in
    plain PyTorch; no CSMSC recipe uses it."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, _get_padding(kernel_size, d), d)
            for d in dilations
        )

    def forward(self, x):
        x = x.transpose(1, 2)
        for conv in self.convs:
            x = x + conv(F.leaky_relu(x, LRELU_SLOPE))
        return x.transpose(1, 2)


@register_network("HifiGANGenerator")
class HifiGANGenerator(nn.Module):
    """[B, T, num_mels] -> [B, T * prod(upsample_rates), 1] waveform."""

    def __init__(
        self,
        resblock_kernel_sizes: Sequence[int],
        resblock_dilation_sizes: Sequence[Sequence[int]],
        upsample_rates: Sequence[int],
        upsample_initial_channel: int,
        upsample_kernel_sizes: Sequence[int],
        num_mels: int = 80,
    ):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        c0 = upsample_initial_channel
        self.conv_pre = WNConv1d(num_mels, c0, 7, padding=3)
        ups, blocks = [], []
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            ups.append(WNConvTranspose1d(c0 // (2**i), ch, k, u, (k - u) // 2))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                blocks.append(ResBlock1(ch, rk, tuple(rd)))
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(blocks)
        self.conv_post = WNConv1d(c0 // (2 ** len(ups)), 1, 7, padding=3)

    def forward(self, x):
        x = self.conv_pre(x.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE)).transpose(1, 2).contiguous()  # [B, T, C]
            acc = None
            for j in range(self.num_kernels):
                r = self.resblocks[i * self.num_kernels + j](x)
                acc = r if acc is None else acc + r
            x = (acc / self.num_kernels).transpose(1, 2)
        # the reference's final activation uses torch's DEFAULT slope 0.01
        # (generator.py:52), not the resblock slope
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x).transpose(1, 2)


def generator_upsample_ratio(decoder_config) -> int:
    """Samples per input frame: prod(upsample_rates)."""
    return math.prod(int(u) for u in decoder_config["upsample_rates"])
