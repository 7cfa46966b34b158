"""Speaker-embedding networks: ECAPA-TDNN and the x-vector TDNN
(counterpart of ``msmctts_tpu/models/tdnn.py``).

``ECAPA_TDNN`` is the QS-TTS ``global_encoder``: a Conv-ReLU-BN stem, three
SE-Res2Blocks (dilations 2 / 3 / 4), a 1x1 conv over their concatenation,
attentive statistics pooling and a BN + linear + BN head; ``manipulate``
mixes the statistics of several reference utterances. Activations are
[B, T, C] as in the JAX package; the convs run in NCL internally. Names
follow the reference torch modules (``conv`` / ``bn``, ``convs.i`` /
``bns.i``, ``linear1`` / ``linear2``, an SE-Res2Block as a ``Sequential``
of four).

:class:`BatchNorm` is flax's ``BatchNorm(momentum=0.9)``, not torch's: in
``train()`` mode it normalizes with the batch statistics of the fast
formula ``var = max(E[x^2] - E[x]^2, 0)`` (biased) and moves the running
statistics with that same biased variance (``torch.nn.BatchNorm1d`` moves
them with the unbiased one, so its ``batch_stats`` would leave JAX's after
one step). Under a process group (``set_group``) the two moments are summed
over the ranks through the differentiable all-reduce, so W ranks normalize
and update with the global batch's statistics, as the JAX package's mesh
does, and the running statistics stay equal on every rank.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from msmctts_tpu_torch.ops.convs import Conv1x1
from msmctts_tpu_torch.ops.dropout import Dropout
from msmctts_tpu_torch.parallel.mesh import sum_over_ranks
from msmctts_tpu_torch.parallel.precision import Conv1d, Linear, result_dtype

BN_MOMENTUM = 0.9  # flax momentum = 1 - torch momentum (0.1)
BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over every axis but the last of [..., C]
    (``weight`` = flax ``scale``, ``running_mean`` / ``running_var`` = the
    ``batch_stats`` ``mean`` / ``var``)."""

    def __init__(self, channels: int, momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.group = None  # parallel.mesh.Group of a data-parallel trainer
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, train: Optional[bool] = None):
        train = self.training if train is None else train
        if train:
            C = x.shape[-1]
            flat = x.float().reshape(-1, C)
            moments = torch.stack([flat.sum(dim=0), (flat * flat).sum(dim=0),
                                   torch.full((C,), float(flat.shape[0]), device=x.device)])
            moments = sum_over_ranks(moments, self.group)
            mean, mean_sq = moments[0] / moments[2], moments[1] / moments[2]
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean + (1.0 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var + (1.0 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        # fp32 statistics and normalization, the result in the promoted
        # dtype of input, scale and bias, as flax's _normalize returns it
        return ((x - mean) * mul + self.bias).to(result_dtype(x, self.weight, self.bias))


def _conv_nlc(conv: nn.Conv1d, x):
    return conv(x.transpose(1, 2)).transpose(1, 2)


class Conv1dReluBn(nn.Module):
    """conv1d -> relu -> BN (reference tdnn.py:109-117)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1, dilation: int = 1,
                 padding: int = 0, bias: bool = False):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size, padding=padding, dilation=dilation, bias=bias)
        self.bn = BatchNorm(out_channels)

    def forward(self, x, train: Optional[bool] = None):
        return self.bn(F.relu(_conv_nlc(self.conv, x)), train)


class Res2Conv1dReluBn(nn.Module):
    """Res2Net split conv (tdnn.py:68-104): ``scale`` channel groups; each
    group after the first adds the previous group's output before its conv;
    the last group passes through."""

    def __init__(self, channels: int, kernel_size: int = 1, dilation: int = 1, padding: int = 0, scale: int = 4):
        super().__init__()
        if channels % scale:
            raise ValueError(f"{channels} channels do not split into {scale} groups")
        self.scale = scale
        self.width = channels // scale
        self.nums = scale if scale == 1 else scale - 1
        self.convs = nn.ModuleList(
            Conv1d(self.width, self.width, kernel_size, padding=padding, dilation=dilation, bias=False)
            for _ in range(self.nums)
        )
        self.bns = nn.ModuleList(BatchNorm(self.width) for _ in range(self.nums))

    def forward(self, x, train: Optional[bool] = None):
        splits = torch.split(x, self.width, dim=-1)
        out, sp = [], None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = splits[i] if i == 0 else sp + splits[i]
            sp = bn(F.relu(_conv_nlc(conv, sp)), train)
            out.append(sp)
        if self.scale != 1:
            out.append(splits[self.nums])
        return torch.cat(out, dim=-1)


class SE_Connect(nn.Module):
    """Squeeze-excite over the time mean (tdnn.py:122-135)."""

    def __init__(self, channels: int, s: int = 2):
        super().__init__()
        self.linear1 = Linear(channels, channels // s)
        self.linear2 = Linear(channels // s, channels)

    def forward(self, x):
        out = torch.mean(x, dim=1)
        out = torch.sigmoid(self.linear2(F.relu(self.linear1(out))))
        return x * out[:, None, :]


class SE_Res2Block(nn.Sequential):
    """1x1 -> Res2Conv -> 1x1 -> SE (tdnn.py:141-152); the residual is
    added by the caller's ``forward``, here."""

    def __init__(self, channels: int, kernel_size: int, dilation: int, padding: int, scale: int):
        super().__init__(
            Conv1dReluBn(channels, channels, 1),
            Res2Conv1dReluBn(channels, kernel_size, dilation, padding, scale),
            Conv1dReluBn(channels, channels, 1),
            SE_Connect(channels),
        )

    def forward(self, x, train: Optional[bool] = None):
        h = self[0](x, train)
        h = self[1](h, train)
        h = self[2](h, train)
        return x + self[3](h)


def _softmax(x, dim):
    """``jax.nn.softmax`` as it computes: exp of the max-shifted input, over
    its sum, each op in the input's dtype. Under bf16 that rounds twice,
    where ``torch.softmax`` rounds once; the ECAPA pooling reads a bf16
    input under ``precision: bfloat16``."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True).detach())
    return e / e.sum(dim=dim, keepdim=True)


class AttentiveStatsPool(nn.Module):
    """Attentive weighted mean and std over time (tdnn.py:157-172); the
    variance is clamped at 1e-9 before the square root."""

    def __init__(self, in_dim: int, bottleneck_dim: int = 128):
        super().__init__()
        self.linear1 = Conv1x1(in_dim, bottleneck_dim)
        self.linear2 = Conv1x1(bottleneck_dim, in_dim)

    def forward(self, x):
        alpha = torch.tanh(self.linear1(x))
        alpha = _softmax(self.linear2(alpha), dim=1)
        mean = torch.sum(alpha * x, dim=1)
        residuals = torch.sum(alpha * x * x, dim=1) - mean * mean
        std = torch.sqrt(torch.clamp(residuals, min=1e-9))
        return torch.cat([mean, std], dim=-1)


class ECAPA_TDNN(nn.Module):
    """[B, T, in_channels] (e.g. mel) -> [B, embd_dim] speaker embedding.
    ``train`` (default: the module's mode) picks batch or running BN
    statistics, as the JAX package's ``train`` argument does."""

    def __init__(self, in_channels: int = 80, embd_dim: int = 192, channels: int = 512, scale: int = 8):
        super().__init__()
        C = channels
        self.layer1 = Conv1dReluBn(in_channels, C, 5, padding=2)
        self.layer2 = SE_Res2Block(C, 3, 2, 2, scale)
        self.layer3 = SE_Res2Block(C, 3, 3, 3, scale)
        self.layer4 = SE_Res2Block(C, 3, 4, 4, scale)
        self.conv = Conv1x1(C * 3, C * 3)
        self.pooling = AttentiveStatsPool(C * 3, 128)
        self.bn1 = BatchNorm(C * 6)
        self.linear = Linear(C * 6, embd_dim)
        self.bn2 = BatchNorm(embd_dim)

    def set_group(self, group):
        """Global-batch BN statistics over ``group`` (``None``: one process)."""
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group = group

    def _stats(self, x, train):
        out1 = self.layer1(x, train)
        out2 = self.layer2(out1, train)
        out3 = self.layer3(out2, train)
        out4 = self.layer4(out3, train)
        out = F.relu(self.conv(torch.cat([out2, out3, out4], dim=-1)))
        return self.pooling(out)

    def forward(self, x, train: Optional[bool] = None):
        out = self.bn1(self._stats(x, train), train)
        return self.bn2(self.linear(out), train)

    def manipulate(self, refs: Sequence[torch.Tensor], alpha: torch.Tensor, train: Optional[bool] = None):
        """Weighted mixing of per-reference statistics (tdnn.py:215-244):
        means combined linearly, stds log-linearly."""
        means, stds = [], []
        for i, seq in enumerate(refs):
            mean, std = torch.chunk(self._stats(seq, train), 2, dim=-1)
            means.append(mean * alpha[:, i : i + 1])
            stds.append(torch.log(torch.clamp(std, min=1e-9)) * alpha[:, i : i + 1])
        mixed = torch.cat([sum(means), torch.exp(sum(stds))], dim=-1)
        return self.bn2(self.linear(self.bn1(mixed, train)), train)


class XVectorTDNN(nn.Module):
    """Classic x-vector (tdnn.py:7-60): five TDNN conv layers, mean / std
    pooling, three FC layers. In ``train()`` mode dropout draws from the
    trainer's generator (``ops/dropout.py``) and the statistics' input gets
    ``eps``-scaled Gaussian noise from the same generator."""

    PLAN = ((512, 5, 1), (512, 5, 2), (512, 7, 3), (512, 1, 1), (1500, 1, 1))

    def __init__(self, in_channels: int, out_channels: int, p_dropout: float = 0.2):
        super().__init__()
        convs, bns, c_in = [], [], in_channels
        for c, k, d in self.PLAN:
            convs.append(Conv1d(c_in, c, k, dilation=d))
            bns.append(BatchNorm(c))
            c_in = c
        self.tdnn = nn.ModuleList(convs)
        self.bn = nn.ModuleList(bns)
        self.fc = nn.ModuleList([Linear(2 * c_in, 512), Linear(512, 512), Linear(512, out_channels)])
        self.bn_fc = nn.ModuleList([BatchNorm(512), BatchNorm(512)])
        self.drop = Dropout(p_dropout)

    def forward(self, x, eps: float = 1e-5):
        h = x
        for conv, bn in zip(self.tdnn, self.bn):
            h = self.drop(bn(F.relu(_conv_nlc(conv, h))))
        if self.training:  # drawn for the global batch, as ops/dropout.py draws its masks
            rank, world = self.drop.shard
            B = h.shape[0]
            noise = torch.randn((B * world, *h.shape[1:]), generator=self.drop.generator, device=h.device, dtype=h.dtype)
            h = h + eps * noise[rank * B : (rank + 1) * B]
        h = torch.cat([torch.mean(h, dim=1), torch.std(h, dim=1, unbiased=False)], dim=-1)
        for fc, bn in zip(self.fc[:2], self.bn_fc):
            h = self.drop(bn(F.relu(fc(h))))
        return self.fc[2](h)
