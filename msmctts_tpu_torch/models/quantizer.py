"""Multi-head EMA vector quantization (counterpart of
``msmctts_tpu/models/quantizer.py``).

All heads share one codebook tensor [H, d, K] (``embed``), kept whole as
in the JAX package. In ``eval()`` mode every snap goes through
``ops/vq.vq_nearest_sharded`` (``csrc/vq_nearest.cu`` on the card, on this process's rows)
and nothing is updated: at
inference the JAX package discards the statistics (its ``codebook``
collection is not mutable there, ``quantizer.py:169``). In ``train()`` mode
with ``update``, one ``ops/vq.vq_nearest_stats_sharded`` launch (``csrc/vq_stats.cu``) gives
the indices, the codewords of the *old* codebook and the masked counts and
sums, and the EMA update (``quantizer.py:184-188``) then runs in plain
tensor code on the buffers, in place, under ``no_grad``. ``train()`` mode
is the port's counterpart of flax's mutable ``codebook`` collection. The
statistics call and the update are the spans ``quantizer.stats`` and
``quantizer.ema`` (``utils/tracing.py``); where the forward is captured as
CUDA graphs, both run eagerly between them (``utils/graphs.py``).

The acoustic model's triplet loss (``compute_triple_loss``) needs every
distance to the codebook with its gradient: it takes them from the plain
``codebook_distances``, as the JAX package takes them from its unfused
``nearest_codes`` outside any Pallas kernel.

Under data parallelism the trainer gives the module its process group
(``group``): the training forward then goes through
``ops/vq.vq_nearest_stats_sharded``, which sums the statistics over ranks,
and ``ema_update`` runs on every rank on equal inputs, so the replicated
codebooks stay bit-equal. Every snap goes through
``ops/vq.vq_nearest_sharded`` (the rank's rows, no collective).

``restart_dead > 0`` re-seeds, after each EMA update, every codeword whose
EMA count fell below it from a row of the batch (``quantizer.py:190-203``):
its codeword and ``embed_avg`` become that row, its count 1.0. The rows are
drawn from the trainer's ``torch.Generator`` (bound by
``ops/dropout.bind_generator``) over the *global* batch's B * T rows; under
a group each rank fills the seeds of the rows it holds, zeros elsewhere, and
one ``all_reduce`` sums them, so W ranks restart what one rank restarts.
``sort=True`` returns the nearest-first ranking of every codeword from the
plain distances (``codebook_distances``), as the JAX package takes it from
its unfused path; ``sample`` draws codewords from the EMA counts.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from msmctts_tpu_torch.ops.masking import sequence_mask
from msmctts_tpu_torch.ops.vq import vq_nearest_sharded, vq_nearest_stats_sharded
from msmctts_tpu_torch.parallel.mesh import all_reduce_sum, rank, world
from msmctts_tpu_torch.utils.graphs import outside_graphs
from msmctts_tpu_torch.utils.tracing import span


def codebook_distances(x, embed):
    """x [..., H, d], embed [H, d, K] -> squared distances [..., H, K] in
    fp32, ``|x|^2 - 2 x.E + |E|^2`` in the JAX package's order
    (``msmctts_tpu/models/quantizer.py:34-47``). Plain and differentiable:
    the triplet loss needs every distance and its gradient, which the snap
    kernel never materializes."""
    x = x.float()
    embed = embed.float()
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)  # [..., H, 1]
    e_sq = torch.sum(embed * embed, dim=1)  # [H, K]
    xe = torch.einsum("...hd,hdk->...hk", x, embed)
    return x_sq - 2.0 * xe + e_sq


def nearest_codes(x, embed):
    """x [..., H, d], embed [H, d, K] -> (indices [..., H] int32,
    codewords [..., H, d]). Unlike the JAX function, which returns the
    distance matrix, this returns the gathered codewords: the kernel never
    materializes the distances."""
    lead = x.shape[:-2]
    H, d = x.shape[-2:]
    idx, quant = vq_nearest_sharded(x.reshape(-1, H, d), embed)
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
    binds_generator = True  # ops/dropout.bind_generator sets ``generator``

    def __init__(self, embed_dim: int, n_embed: int, n_head: int = 1, restart_dead: float = 0.0):
        super().__init__()
        if embed_dim % n_head:
            raise ValueError(f"embed_dim {embed_dim} does not split into {n_head} heads")
        self.n_head = n_head
        self.n_embed = n_embed
        self.sub_dim = embed_dim // n_head
        self.restart_dead = float(restart_dead)
        self.group = None  # parallel.mesh.Group of a data-parallel trainer
        self.generator = None  # the trainer's; the restarts' rows are drawn from it
        embed = torch.randn(n_head, self.sub_dim, n_embed)
        self.register_buffer("embed", embed)
        self.register_buffer("cluster_size", torch.zeros(n_head, n_embed))
        self.register_buffer("embed_avg", embed.clone())

    def quantize(self, x):
        """Snap [B, T, D] to nearest codewords -> (quant [B, T, D],
        indices [B, T, H])."""
        B, T, D = x.shape
        idx, quant = nearest_codes(x.float().reshape(B, T, self.n_head, self.sub_dim), self.embed)
        return quant.reshape(B, T, D).to(x.dtype), idx

    @torch.no_grad()
    def ema_update(self, counts, sums, rows=None):
        """EMA of cluster sizes and codeword sums, then the Laplace-smoothed
        codebook (``quantizer.py:184-188``), written in place; with
        ``restart_dead``, the dead codewords re-seeded from ``rows``
        [N, H, d] (this rank's fp32 rows of the batch)."""
        K = self.n_embed
        new_cs = self.cluster_size * self.decay + (1.0 - self.decay) * counts
        new_ea = self.embed_avg * self.decay + (1.0 - self.decay) * sums
        n = new_cs.sum(dim=-1, keepdim=True)  # [H, 1]
        smoothed = (new_cs + self.eps) / (n + K * self.eps) * n  # [H, K]
        new_embed = new_ea / smoothed[:, None, :]
        if self.restart_dead > 0:
            seeds = self.restart_seeds(rows)
            dead = (new_cs < self.restart_dead)[:, None, :]  # [H, 1, K]
            new_embed = torch.where(dead, seeds, new_embed)
            new_ea = torch.where(dead, seeds, new_ea)
            new_cs = torch.where(dead[:, 0, :], torch.ones_like(new_cs), new_cs)
        self.cluster_size.copy_(new_cs)
        self.embed_avg.copy_(new_ea)
        self.embed.copy_(new_embed)

    @torch.no_grad()
    def restart_seeds(self, rows):
        """Candidate seeds [H, d, K]: for every (head, codeword) one row of
        the global batch's, drawn uniformly from the trainer's generator
        (every rank draws the same indices); the rank holding the row fills
        it in and one all-reduce gives every rank all of them."""
        if self.generator is None:
            raise RuntimeError("restart_dead needs a generator: call bind_generator(model, generator) first")
        H, K = self.n_head, self.n_embed
        N = rows.shape[0]
        draw = torch.randint(0, N * world(self.group), (H, K), generator=self.generator, device=rows.device)
        local = draw - rank(self.group) * N
        held = (local >= 0) & (local < N)
        heads = torch.arange(H, device=rows.device)[:, None]
        seeds = rows[local.clamp(0, N - 1), heads] * held[..., None]  # [H, K, d]
        return all_reduce_sum(seeds, self.group).transpose(1, 2)

    def _update(self, xf, mask):
        """The statistics call over rows ``xf`` [N, H, d] and the EMA update
        -> (indices [N, H], codewords of the codebook before the update
        [N, H, d]). Both stay eager inside a train step's CUDA graphs
        (``utils/graphs.outside_graphs``)."""
        with span("quantizer.stats"):
            idx, quant, counts, sums = vq_nearest_stats_sharded(xf, self.embed, mask, self.group)
        with span("quantizer.ema"):
            self.ema_update(counts, sums, xf)
        return idx, quant

    def forward(self, x, lengths=None, update: bool = True, sort: bool = False):
        """x [B, T, D] -> (quantized (straight-through), diff [B, T, D] fp32,
        indices [B, T, H] int32); ``quantizer.py:112-220``. The codebook
        moves iff the module is in training mode and ``update``; frames at
        t >= lengths[b] are left out of its statistics, which cover the
        batch rows of every rank of ``self.group``. The codewords
        returned are those of the codebook before the update. ``sort=True``
        returns in place of the indices the nearest-first ranking of the
        codewords, [B, T, H, K], or [B, T, K] for one head (the reference
        shape; ``quantizer.py:216-219``)."""
        B, T, D = x.shape
        ranking = self.rank_codewords(x) if sort else None
        if self.training and update:
            if lengths is None:
                mask = torch.ones(B * T, dtype=torch.float32, device=x.device)
            else:
                mask = sequence_mask(lengths, T, dtype=torch.float32).reshape(B * T)
            xf = x.detach().float().reshape(B * T, self.n_head, self.sub_dim)
            idx, quant = outside_graphs(self._update, xf, mask)
            indices = idx.reshape(B, T, self.n_head)
            quant = quant.reshape(B, T, D)
        else:
            quant, indices = self.quantize(x.detach().float())
        # commitment diff in float32 from the fp32 codewords; gradients reach
        # x only; the codewords return in x's dtype (quantizer.py:209-214)
        diff = torch.square(quant - x.float())
        quant = quant.to(x.dtype)
        quant_st = x + (quant - x).detach()
        return quant_st, diff, (indices if ranking is None else ranking)

    @torch.no_grad()
    def rank_codewords(self, x):
        """Every codeword's rank by distance to each row of x [B, T, D],
        nearest first (a stable sort, as ``jnp.argsort``): int32 [B, T, H, K],
        [B, T, K] for one head."""
        B, T, _ = x.shape
        dist = codebook_distances(x.detach().float().reshape(B, T, self.n_head, self.sub_dim), self.embed)
        ranking = torch.argsort(dist, dim=-1, stable=True).to(torch.int32)
        return ranking[:, :, 0] if self.n_head == 1 else ranking

    @torch.no_grad()
    def sample(self, generator, batch_shape):
        """Codewords drawn from the EMA counts (``quantizer.py:244-259``): per
        head, indices ~ Categorical(max(cluster_size, eps) / sum) from
        ``generator`` -> (indices [*batch_shape, H] int64, codewords
        [*batch_shape, H, d])."""
        batch_shape = tuple(batch_shape)
        n = math.prod(batch_shape)
        probs = torch.clamp(self.cluster_size, min=self.eps)  # [H, K]
        idx = torch.multinomial(probs / probs.sum(dim=-1, keepdim=True), n, replacement=True, generator=generator)
        idx = idx.T.reshape(*batch_shape, self.n_head)
        return idx, lookup_codes(idx, self.embed)

    def compute_triple_loss(self, pred, target_indices, reduction: str = "mean", margin: float = 1e-6):
        """Triplet loss of predictions [B, T, D] against the codebook
        (``quantizer.py:260-283``), averaged over heads -> [B, T]: the
        squared error to the target codeword against the distances to all
        codewords, hinged at ``margin``, with the target entry masked out by
        the exact test ``pos_loss - dist != 0`` (kept in the JAX order of
        operations, so that the same entries drop out)."""
        B, T, D = pred.shape
        H, d = self.n_head, self.sub_dim
        if target_indices.dim() == 2:
            target_indices = target_indices[..., None]
        ph = pred.reshape(B, T, H, d).float()
        dist = codebook_distances(ph, self.embed)  # [B, T, H, K]
        target = lookup_codes(target_indices, self.embed)  # [B, T, H, d]
        pos_loss = torch.sum(torch.square(ph - target.float()), dim=-1)  # [B, T, H]
        raw = pos_loss[..., None] - dist  # zero exactly at the target codeword
        self_mask = (raw != 0).float()
        # maximum, not clamp: on a tie it splits the gradient as jnp.maximum does
        hinge = torch.maximum(raw + margin, torch.zeros_like(raw)) * self_mask / d  # [B, T, H, K]
        per_head = torch.mean(hinge, dim=-1) if reduction == "mean" else torch.sum(hinge, dim=-1)
        return torch.mean(per_head, dim=-1)
