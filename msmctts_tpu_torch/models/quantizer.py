"""Multi-head VQ at inference (counterpart of
``msmctts_tpu/models/quantizer.py``).

All heads share one codebook tensor [H, d, K] (``embed``), kept whole as
in the JAX package. Every snap goes through ``ops/vq.py`` (kernel 1 on the
card). The EMA statistics are training state and are not computed: at
inference the JAX package discards them (its ``codebook`` collection is not
mutable there, ``quantizer.py:169``), so no output changes.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from msmctts_tpu_torch.ops.vq import vq_nearest


def nearest_codes(x, embed):
    """x [..., H, d], embed [H, d, K] -> (indices [..., H] int32,
    codewords [..., H, d]). Unlike the JAX function, which returns the
    distance matrix, this returns the gathered codewords: the kernel never
    materializes the distances."""
    lead = x.shape[:-2]
    H, d = x.shape[-2:]
    idx, quant = vq_nearest(x.reshape(-1, H, d), embed)
    return idx.reshape(*lead, H), quant.reshape(*lead, H, d)


def lookup_codes(indices, embed):
    """indices [..., H], embed [H, d, K] -> [..., H, d]."""
    table = embed.transpose(1, 2)  # [H, K, d]
    heads = torch.arange(embed.shape[0], device=embed.device)
    return table[heads, indices.long()]


class EMAQuantizer(nn.Module):
    """H-head codebook over inputs [B, T, embed_dim] (buffers ``embed``
    [H, d, K], ``cluster_size`` [H, K], ``embed_avg`` [H, d, K])."""

    def __init__(self, embed_dim: int, n_embed: int, n_head: int = 1):
        super().__init__()
        if embed_dim % n_head:
            raise ValueError(f"embed_dim {embed_dim} does not split into {n_head} heads")
        self.n_head = n_head
        self.sub_dim = embed_dim // n_head
        embed = torch.randn(n_head, self.sub_dim, n_embed)
        self.register_buffer("embed", embed)
        self.register_buffer("cluster_size", torch.zeros(n_head, n_embed))
        self.register_buffer("embed_avg", embed.clone())

    def quantize(self, x):
        """Snap [B, T, D] to nearest codewords -> (quant [B, T, D],
        indices [B, T, H])."""
        B, T, D = x.shape
        idx, quant = nearest_codes(x.reshape(B, T, self.n_head, self.sub_dim), self.embed)
        return quant.reshape(B, T, D).to(x.dtype), idx

    def forward(self, x):
        """x [B, T, D] -> (quantized (straight-through form), diff,
        indices [B, T, H]); matches ``quantizer.py:112-220`` with no EMA
        update (frame lengths only mask the statistics, so none are taken)."""
        quant, indices = self.quantize(x)
        diff = torch.square(quant.float() - x.float())
        # the straight-through form's forward value: x + (quant - x)
        quant_st = x + (quant - x)
        return quant_st, diff, indices
