"""Multi-head EMA vector quantization (counterpart of
``msmctts_tpu/models/quantizer.py``).

All heads share one codebook tensor [H, d, K] (``embed``), kept whole as
in the JAX package. In ``eval()`` mode every snap goes through
``ops/vq.vq_nearest`` (kernel 1 on the card) and nothing is updated: at
inference the JAX package discards the statistics (its ``codebook``
collection is not mutable there, ``quantizer.py:169``). In ``train()`` mode
with ``update``, one ``ops/vq.vq_nearest_stats`` launch (kernel 3) gives
the indices, the codewords of the *old* codebook and the masked counts and
sums, and the EMA update (``quantizer.py:184-188``) then runs in plain
tensor code on the buffers, in place, under ``no_grad``. ``train()`` mode
is the port's counterpart of flax's mutable ``codebook`` collection.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from msmctts_tpu_torch.ops.masking import sequence_mask
from msmctts_tpu_torch.ops.vq import vq_nearest, vq_nearest_stats


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

    decay = 0.99  # of the EMA of cluster sizes and codeword sums
    eps = 1e-5  # Laplace smoothing of the cluster sizes

    def __init__(self, embed_dim: int, n_embed: int, n_head: int = 1, restart_dead: float = 0.0):
        super().__init__()
        if embed_dim % n_head:
            raise ValueError(f"embed_dim {embed_dim} does not split into {n_head} heads")
        if restart_dead > 0:
            raise NotImplementedError("restart_dead > 0 (dead-codeword restarts) is not ported")
        self.n_head = n_head
        self.n_embed = n_embed
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

    @torch.no_grad()
    def ema_update(self, counts, sums):
        """EMA of cluster sizes and codeword sums, then the Laplace-smoothed
        codebook (``quantizer.py:184-188``), written in place."""
        K = self.n_embed
        new_cs = self.cluster_size * self.decay + (1.0 - self.decay) * counts
        new_ea = self.embed_avg * self.decay + (1.0 - self.decay) * sums
        n = new_cs.sum(dim=-1, keepdim=True)  # [H, 1]
        smoothed = (new_cs + self.eps) / (n + K * self.eps) * n  # [H, K]
        self.cluster_size.copy_(new_cs)
        self.embed_avg.copy_(new_ea)
        self.embed.copy_(new_ea / smoothed[:, None, :])

    def forward(self, x, lengths=None, update: bool = True, sort: bool = False):
        """x [B, T, D] -> (quantized (straight-through), diff [B, T, D] fp32,
        indices [B, T, H] int32); ``quantizer.py:112-220``. The codebook
        moves iff the module is in training mode and ``update``; frames at
        t >= lengths[b] are left out of its statistics. The codewords
        returned are those of the codebook before the update."""
        if sort:
            raise NotImplementedError("sort=True (full codeword ranking) is not ported")
        B, T, D = x.shape
        if self.training and update:
            if lengths is None:
                mask = torch.ones(B * T, dtype=torch.float32, device=x.device)
            else:
                mask = sequence_mask(lengths, T, dtype=torch.float32).reshape(B * T)
            xf = x.detach().float().reshape(B * T, self.n_head, self.sub_dim)
            idx, quant, counts, sums = vq_nearest_stats(xf, self.embed, mask)
            indices = idx.reshape(B, T, self.n_head)
            quant = quant.reshape(B, T, D).to(x.dtype)
            self.ema_update(counts, sums)
        else:
            quant, indices = self.quantize(x.detach())
        # commitment diff in float32; gradients reach x only
        diff = torch.square(quant.float() - x.float())
        quant_st = x + (quant - x).detach()
        return quant_st, diff, indices
