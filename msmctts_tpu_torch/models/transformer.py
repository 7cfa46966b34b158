"""FastSpeech-style transformer blocks (counterpart of
``msmctts_tpu/models/transformer.py``). Dropout sits where the JAX package
applies it (attention weights, attention output, FFN output, both layer
norms of the duration predictor) and draws from
the generator the trainer binds (``ops/dropout.py``); in ``eval()`` it is
the identity.

Parameter names follow the reference torch modules (``layer_stack``,
``slf_attn.linear`` fused QKV, ``slf_attn.fc``, ``pos_ffn.w_1``, ...), so a
JAX params tree maps onto them through ``weights.py``. Activations are
[B, T, C]; the FFN convs run in NCL internally.

Parity traps kept from the JAX package: LayerNorm eps 1e-5; the key mask
fills with the finite ``NEG_INF = -1e9`` (a fully padded row gives the same
uniform softmax); positions clip to ``max_seq_len``; the length regulator
maps frame t to the count of phone ends <= t, clamped to Lt - 1, and rounds
durations half to even (``torch.round``). Attention is plain matmul and
softmax, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from msmctts_tpu_torch.ops.dropout import Dropout
from msmctts_tpu_torch.parallel.precision import Conv1d, LayerNorm, Linear

LAYERNORM_EPS = 1e-5
NEG_INF = -1e9


@functools.lru_cache(maxsize=None)
def sinusoid_position_table(n_position: int, d_hid: int) -> np.ndarray:
    """Sinusoid table [n_position, d_hid]; row 0 zeroed (padding_idx).
    angle(pos, j) = pos / 10000^(2*(j//2)/d_hid), sin at even dims, cos at
    odd dims (reference transformer.py:388-407)."""
    position = np.arange(n_position, dtype=np.float64)[:, None]
    dim = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = position / np.power(10000.0, 2.0 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    table[0] = 0.0
    return table.astype(np.float32)


def _same_padding(kernel_size: int):
    """flax's ``"SAME"`` padding of a stride-1 conv: (k - 1) // 2 frames
    before, k // 2 after (``msmctts_tpu/models/transformer.py:101-103``).
    torch's ``"same"`` splits an even kernel's padding the same way, so an
    odd kernel keeps its symmetric int and an even one takes ``"same"``."""
    return (kernel_size - 1) // 2 if kernel_size % 2 else "same"


class MultiHeadAttention(nn.Module):
    """Fused-QKV self-attention with key-padding mask + residual + LN."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int,
                 dropout: float = 0.1, attn_dropout: float = 0.1):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.linear = Linear(d_model, n_head * (2 * d_k + d_v))
        self.fc = Linear(n_head * d_v, d_model)
        self.layer_norm = LayerNorm(d_model, eps=LAYERNORM_EPS)
        self.attn_dropout = Dropout(attn_dropout)
        self.dropout = Dropout(dropout)

    def forward(self, x, key_pad):
        B, T, _ = x.shape
        qkv = self.linear(x).view(B, T, self.n_head, 2 * self.d_k + self.d_v)
        q = qkv[..., : self.d_k]
        k = qkv[..., self.d_k : 2 * self.d_k]
        v = qkv[..., 2 * self.d_k :]
        # the JAX scale is a numpy scalar, which promotes a bf16 product to
        # fp32 (msmctts_tpu/models/transformer.py:72-73); so does this cast
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / np.sqrt(self.d_k))
        attn = attn.masked_fill(key_pad[:, None, None, :], NEG_INF)
        attn = self.attn_dropout(torch.softmax(attn, dim=-1))
        # einsum promotes its operands in JAX (transformer.py:77)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v.to(attn.dtype)).reshape(B, T, self.n_head * self.d_v)
        return self.layer_norm(self.dropout(self.fc(out)) + x)


class ConvFFN(nn.Module):
    """conv1d(k) -> relu -> conv1d(k) -> dropout -> residual -> LN."""

    def __init__(self, d_model: int, d_inner: int, kernel_size: int = 3, dropout: float = 0.1):
        super().__init__()
        self.dropout = Dropout(dropout)
        pad = _same_padding(kernel_size)
        self.w_1 = Conv1d(d_model, d_inner, kernel_size, padding=pad)
        self.w_2 = Conv1d(d_inner, d_model, kernel_size, padding=pad)
        self.layer_norm = LayerNorm(d_model, eps=LAYERNORM_EPS)

    def forward(self, x):
        h = self.w_2(F.relu(self.w_1(x.transpose(1, 2)))).transpose(1, 2)
        return self.layer_norm(self.dropout(h) + x)


class FFTBlock(nn.Module):
    def __init__(self, d_model, d_inner, n_head, d_k, d_v, kernel_size=3, dropout=0.1, attn_dropout=0.1):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, d_k, d_v, dropout, attn_dropout)
        self.pos_ffn = ConvFFN(d_model, d_inner, kernel_size, dropout)

    def forward(self, x, key_pad, non_pad):
        x = self.slf_attn(x, key_pad) * non_pad
        return self.pos_ffn(x) * non_pad


class FFTBlocks(nn.Module):
    """N FFT blocks over [B, T, d_model] with 1-based position ids
    (0 = padding). The reference's extra config keys are accepted for YAML
    parity."""

    def __init__(
        self,
        max_seq_len: int,
        n_layers: int,
        n_head: int,
        d_k: int,
        d_v: int,
        d_model: int,
        d_inner: int,
        fft_conv1d_kernel: int = 3,
        fft_conv1d_padding: int = 1,
        dropout: float = 0.1,
        attn_dropout: float = 0.1,
        fused_layernorm: bool = False,
    ):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.register_buffer(
            "position_table",
            torch.from_numpy(sinusoid_position_table(max_seq_len + 1, d_model)),
            persistent=False,
        )
        self.layer_stack = nn.ModuleList(
            FFTBlock(d_model, d_inner, n_head, d_k, d_v, fft_conv1d_kernel, dropout, attn_dropout)
            for _ in range(n_layers)
        )

    def forward(self, x, pos):
        """x [B, T, d_model], pos [B, T] -> (x, non_pad [B, T, 1])."""
        pos = torch.clamp(pos, 0, self.max_seq_len)
        x = x + self.position_table[pos]
        key_pad = pos == 0
        non_pad = (pos != 0)[..., None].to(x.dtype)
        for layer in self.layer_stack:
            x = layer(x, key_pad, non_pad)
        return x, non_pad


def regulate_lengths(x, durations, max_out_len: int):
    """Expand [B, Lt, D] phones by integer durations -> [B, max_out_len, D].

    Output frame t maps to the phone whose cumulative duration first
    exceeds t. Returns (output, out_lengths [B], pos_ids [B, max_out_len])."""
    reps = torch.clamp(torch.round(durations.float()).long(), min=0)
    ends = torch.cumsum(reps, dim=-1)  # [B, Lt]
    out_lengths = ends[:, -1]
    frame = torch.arange(max_out_len, device=x.device)
    # phone index for frame t: number of ends <= t
    idx = torch.searchsorted(ends, frame.expand(x.shape[0], -1).contiguous(), right=True)
    idx = torch.clamp(idx, max=x.shape[1] - 1)
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    valid = frame[None, :] < out_lengths[:, None]
    out = out * valid[..., None].to(x.dtype)
    pos = (frame[None, :] + 1) * valid.long()
    return out, out_lengths, pos


class DurationPredictor(nn.Module):
    """2x(conv1d k -> relu -> LN -> dropout) -> linear -> [B, T] durations
    (reference transformer.py:481-534)."""

    def __init__(self, input_size: int, filter_size: int, kernel: int = 3, dropout: float = 0.1):
        super().__init__()
        pad = _same_padding(kernel)
        self.conv1d_1 = Conv1d(input_size, filter_size, kernel, padding=pad)
        self.layer_norm_1 = LayerNorm(filter_size, eps=LAYERNORM_EPS)
        self.dropout_1 = Dropout(dropout)
        self.conv1d_2 = Conv1d(filter_size, filter_size, kernel, padding=pad)
        self.layer_norm_2 = LayerNorm(filter_size, eps=LAYERNORM_EPS)
        self.dropout_2 = Dropout(dropout)
        self.linear_layer = Linear(filter_size, 1)

    def forward(self, x, non_pad):
        x = x * non_pad
        h = F.relu(self.conv1d_1(x.transpose(1, 2))).transpose(1, 2)
        h = self.dropout_1(self.layer_norm_1(h))
        h = F.relu(self.conv1d_2(h.transpose(1, 2))).transpose(1, 2)
        h = self.dropout_2(self.layer_norm_2(h))
        return (self.linear_layer(h) * non_pad)[..., 0]


class LengthRegulator(nn.Module):
    """Duration predictor + expansion (reference transformer.py:427-478).
    Expands by the given ``target`` durations, else by clamp_min(pred, 0).

    In ``train()`` mode with a ``target`` (teacher forcing) the durations
    returned are the raw predictions, with their graph, for the duration
    loss (the JAX package's ``deterministic=False``); otherwise they are the
    rounded expansion durations, int32."""

    def __init__(
        self,
        input_size: int,
        duration_predictor_filter_size: int,
        duration_predictor_kernel_size: int = 3,
        dropout: float = 0.1,
        fused_layernorm: bool = False,
    ):
        super().__init__()
        self.duration_predictor = DurationPredictor(
            input_size, duration_predictor_filter_size, duration_predictor_kernel_size, dropout
        )

    def forward(self, x, non_pad, max_out_len: int, target: Optional[torch.Tensor] = None):
        """-> (expanded [B, max_out_len, D], out_lengths, pos, durations)."""
        if target is not None:
            expand_dur = target
            # inference with given durations has no use for the predictor
            dur_out = self.duration_predictor(x, non_pad) if self.training else torch.round(target).to(torch.int32)
        else:
            expand_dur = torch.clamp(self.duration_predictor(x, non_pad), min=0.0)
            dur_out = torch.round(expand_dur).to(torch.int32)
        out, out_lengths, pos = regulate_lengths(x, expand_dur, max_out_len)
        return out, out_lengths, pos, dur_out
