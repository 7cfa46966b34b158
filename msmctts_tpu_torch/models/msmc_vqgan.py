"""MSMC-VQ-GAN autoencoder (counterpart of
``msmctts_tpu/models/msmc_vqgan.py:54-511``). ``train()`` mode is the JAX
package's ``deterministic=False`` with a mutable codebook: dropout draws,
the codebook EMA moves and the prior-prediction losses are returned.

Names follow the reference (``in_linear``, ``encoder.encoders.i``,
``quantizer.quantizer.i`` / ``preprocessor.i`` / ``postprocessor.i`` /
``predictor.i`` / ``transposed_conv.i``, ``frame_decoder``,
``mel_predictor``, ``decoder``). The residual chain upsamples by repetition
(``upsampling: repeat``, the mode of every shipped recipe), by a learned
weight-norm transposed conv (``mapping``) or by both, the conv's output
through dropout (``residual``; ``msmc_vqgan.py:168-181,274-282``). ``norm:
True`` appends a :class:`~msmctts_tpu_torch.models.modules.TorchBatchNorm`
to each stage's preprocessor (``preprocessor.i.3``, the JAX package's
``batch_stats`` ``prenorm_i``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from msmctts_tpu_torch.models.hifigan import generator_upsample_ratio
from msmctts_tpu_torch.models.modules import PriorPredictor, TorchBatchNorm
from msmctts_tpu_torch.models.quantizer import EMAQuantizer
from msmctts_tpu_torch.models.transformer import FFTBlocks
from msmctts_tpu_torch.ops.convs import Conv1x1, WNConvTranspose1d
from msmctts_tpu_torch.ops.dropout import Dropout
from msmctts_tpu_torch.ops.masking import positions_from_lengths, sequence_mask
from msmctts_tpu_torch.parallel.mesh import all_reduce_sum
from msmctts_tpu_torch.parallel.precision import Linear
from msmctts_tpu_torch.registry import get_network, register_network


def avg_pool_1d(x, scale: int):
    """Exact average pooling over time ([B, T, C], T % scale == 0)."""
    if scale == 1:
        return x
    B, T, C = x.shape
    if T % scale:
        raise ValueError(f"frame count {T} not divisible by pool scale {scale}")
    return x.reshape(B, T // scale, scale, C).mean(dim=2)


def repeat_upsample(x, scale: int):
    """repeat_interleave along time ([B, T, C] -> [B, T*scale, C])."""
    if scale == 1:
        return x
    return torch.repeat_interleave(x, scale, dim=1)


def crop_windows(x, starts, size: int):
    """x [B, T, ...], starts [B] -> [B, size, ...], row b from ``starts[b]``.
    A start is clamped so that the window stays inside T, as
    ``jax.lax.dynamic_slice`` clamps it (``msmc_vqgan.py:430-434``)."""
    T = x.shape[1]
    if size > T:
        raise ValueError(f"window of {size} does not fit in {T}")
    starts = torch.clamp(starts.long(), 0, T - size)
    index = starts[:, None] + torch.arange(size, device=x.device)[None, :]  # [B, size]
    return x[torch.arange(x.shape[0], device=x.device)[:, None], index]


def _ceil_div(lengths, scale: int):
    return (lengths + scale - 1) // scale


class MultiStageEncoder(nn.Module):
    """Per-stage FFT blocks with pool-by-scale between stages; returns
    fine-to-coarse [(feat, length)]."""

    def __init__(
        self,
        in_channels: int,
        downsample_scales: Sequence[int] = (1,),
        max_seq_len: int = 2400,
        n_layers: int = 4,
        n_head: int = 2,
        d_k: int = 64,
        d_v: int = 64,
        d_inner: int = 1024,
        fft_conv1d_kernel: int = 3,
        fft_conv1d_padding: int = 1,
        dropout: float = 0.2,
        attn_dropout: float = 0.1,
        fused_layernorm: bool = False,
    ):
        super().__init__()
        self.downsample_scales = list(downsample_scales)
        self.encoders = nn.ModuleList(
            FFTBlocks(
                max_seq_len=max_seq_len, n_layers=n_layers, n_head=n_head,
                d_k=d_k, d_v=d_v, d_model=in_channels, d_inner=d_inner,
                fft_conv1d_kernel=fft_conv1d_kernel, dropout=dropout, attn_dropout=attn_dropout,
            )
            for _ in self.downsample_scales
        )

    def forward(self, x, lengths):
        outputs = []
        feat, feat_length = x, lengths
        for scale, encoder in zip(self.downsample_scales, self.encoders):
            if scale > 1:
                feat = avg_pool_1d(feat, scale)
                feat_length = _ceil_div(feat_length, scale)
            pos = positions_from_lengths(feat_length, feat.shape[1])
            feat, _ = encoder(feat, pos)
            outputs.append((feat, feat_length))
        return outputs


class MultiStageQuantizer(nn.Module):
    """Coarsest-first residual multi-stage multi-head quantization."""

    def __init__(
        self,
        n_model_size: int,
        upsample_scales: Sequence[int],
        embedding_sizes=512,
        embedding_dims=256,
        n_heads: int = 4,
        prior_config: Optional[dict] = None,
        norm: bool = False,
        upsampling: str = "repeat",
        dropout: float = 0.1,
        update_codebook: bool = True,
        restart_dead: float = 0.0,
        use_pallas="auto",
    ):
        super().__init__()
        if upsampling not in ("repeat", "mapping", "residual"):
            raise ValueError(f"unknown upsampling '{upsampling}'")
        self.upsampling = upsampling
        self.upsample_scales = list(upsample_scales)
        self.update_codebook = update_codebook
        self.group = None  # see set_group
        self.dropout = Dropout(dropout)
        n_stage = len(self.upsample_scales)
        sizes = embedding_sizes if isinstance(embedding_sizes, (list, tuple)) else [embedding_sizes] * n_stage
        dims = embedding_dims if isinstance(embedding_dims, (list, tuple)) else [embedding_dims] * n_stage
        M = n_model_size
        self.quantizer = nn.ModuleList(
            EMAQuantizer(dims[i], sizes[i], n_head=n_heads, restart_dead=restart_dead) for i in range(n_stage)
        )
        self.preprocessor = nn.ModuleList(
            nn.Sequential(Conv1x1(M if i == 0 else 2 * M, dims[i]), nn.Tanh(), Conv1x1(dims[i], dims[i]),
                          *([TorchBatchNorm(dims[i])] if norm else []))
            for i in range(n_stage)
        )
        self.postprocessor = nn.ModuleList(
            nn.Sequential(Linear(dims[i] if i == 0 else M + dims[i], dims[i]), nn.Tanh(), Linear(dims[i], M))
            for i in range(n_stage)
        )
        # the prior predictor is unused at the coarsest stage
        self.predictor = nn.ModuleDict(
            {str(i): PriorPredictor(M, dims[i], **dict(prior_config or {})) for i in range(1, n_stage)}
        )
        # learned upsamplers: k = 2u for even u, else 2u + 1, padding (k - u) // 2,
        # so that each gives exactly u frames a frame
        self.transposed_conv = None
        if upsampling != "repeat":
            kernels = [2 * u if u % 2 == 0 else 2 * u + 1 for u in self.upsample_scales]
            self.transposed_conv = nn.ModuleList(
                WNConvTranspose1d(M, M, k, u, (k - u) // 2) for k, u in zip(kernels, self.upsample_scales)
            )

    def _upsample(self, i: int, residual):
        """The residual chain's step from stage i's rate to the next's."""
        u = self.upsample_scales[i]
        if self.transposed_conv is None:
            return repeat_upsample(residual, u)
        t = self.transposed_conv[i](residual.transpose(1, 2)).transpose(1, 2)
        if self.upsampling == "mapping":
            return t
        return repeat_upsample(residual, u) + self.dropout(t)

    def padding_reach_frames(self) -> int:
        """Output frames before the end of a frame bucket whose residual
        differs from the same frames in a larger bucket, where the padding
        goes on: the zeros a conv pads with at the bucket's end are not the
        activations of padded frames, as in the JAX package. Walking from
        the coarsest stage, each prior predictor's ResStack convolves the
        residual, padded frames unmasked, over its radius (one more frame
        for a partly valid coarse frame); repetition scales the reach to the
        next rate, and a learned upsampler adds its padding there."""
        reach = 0
        for i, u in enumerate(self.upsample_scales):
            if str(i) in self.predictor:
                reach += sum(conv.padding for conv in self.predictor[str(i)].enc.in_layers) + 1
            reach *= u
            if self.transposed_conv is not None:
                reach += self.transposed_conv[i].padding
        return reach

    def set_group(self, group):
        """Train data-parallel over ``group`` (``parallel/mesh.py``): every
        stage's codebook statistics, batch-norm statistics and restart draws
        and the prior losses' denominators then cover the batch rows of all
        ranks. ``None`` returns to one process."""
        self.group = group
        for m in self.modules():
            if isinstance(m, (EMAQuantizer, TorchBatchNorm)):
                m.group = group

    def forward(self, stages: List[Tuple[Optional[torch.Tensor], torch.Tensor]], from_encoder: bool = True):
        """stages: [(embedding|None, length)] — fine-to-coarse when
        ``from_encoder``, coarsest-first otherwise. Returns coarsest-first
        per-stage lists and the residual output; in training mode also
        ``predictor_diffs``, the masked MSE of each prior prediction."""
        if from_encoder:
            stages = stages[::-1]
        quant_outputs, quant_diffs, quant_indices, lengths_out = [], [], [], []
        pred_states = []
        residual = None
        for i, (embedding, length) in enumerate(stages):
            T = embedding.shape[1] if embedding is not None else residual.shape[1]
            mask = sequence_mask(length, T, dtype=torch.float32)[..., None]
            lengths_out.append(length)

            pred_quant = None
            if residual is not None:
                pred_hidden, pred_quant = self.predictor[str(i)](residual, mask)
                residual = residual + self.dropout(pred_hidden)

            if embedding is None:
                q_input = pred_quant
            elif from_encoder:
                pre_in = embedding if residual is None else torch.cat([embedding, residual], dim=-1)
                q_input = self.preprocessor[i](pre_in)
            else:
                q_input = embedding

            quant, diff, indices = self.quantizer[i](q_input, lengths=length, update=self.update_codebook)

            post_in = quant if residual is None else torch.cat([residual, quant], dim=-1)
            h = self.dropout(self.postprocessor[i](post_in))
            residual = h if residual is None else residual + h

            quant_outputs.append(quant)
            quant_diffs.append(diff)
            quant_indices.append(indices)
            pred_states.append(dict(predictor_outputs=pred_quant, target_outputs=quant, target_indices=indices,
                                    target_lengths=length))
            residual = self._upsample(i, residual)

        out = dict(
            residual_output=residual,
            quantizer_outputs=quant_outputs,
            quantizer_diffs=quant_diffs,
            quantizer_indices=quant_indices,
            quantizer_lengths=lengths_out,
        )
        if self.training:
            out["predictor_diffs"] = self.compute_embedding_loss(pred_states)
        return out

    def compute_embedding_loss(self, pred_states, methods=("mse",), loss_weights=(1.0,)):
        """Per-stage, per-method masked embedding losses
        (``msmc_vqgan.py:301-342``); returns a dict with 'total_loss'.
        ``loss_weights`` is per stage ([[w, ...], ...]) or one list for all.
        Methods: ``mse`` against the target codewords, ``softmax`` (the
        predictions read as logits over their last axis, scored at the
        first head's target index, as the JAX package does), ``triple`` /
        ``triple_mean`` and ``triple_sum`` (``EMAQuantizer.compute_triple_loss``).
        Under a group each loss is this rank's share: its local sum over the
        global denominator."""
        ref = pred_states[0]["target_outputs"]
        loss_dict = {"total_loss": torch.zeros((), dtype=torch.float32, device=ref.device)}
        for i, state in enumerate(pred_states):
            p = state["predictor_outputs"]
            if p is None:
                continue
            weights = loss_weights[i] if isinstance(loss_weights[0], (list, tuple)) else loss_weights
            length = state["target_lengths"]
            mask = sequence_mask(length, p.shape[1], dtype=torch.float32)
            denom = torch.clamp(all_reduce_sum(length.float().sum(), self.group), min=1.0)
            for method, weight in zip(methods, weights):
                if method == "mse":
                    loss = torch.mean(torch.square(p - state["target_outputs"].detach()), dim=-1)  # [B, T]
                elif method == "softmax":
                    t = state["target_indices"]
                    if t.dim() == 3:
                        t = t[..., 0]
                    loss = -torch.gather(torch.log_softmax(p, dim=-1), -1, t[..., None].long())[..., 0]
                elif method in ("triple", "triple_mean"):
                    loss = self.quantizer[i].compute_triple_loss(p, state["target_indices"], reduction="mean")
                elif method == "triple_sum":
                    loss = self.quantizer[i].compute_triple_loss(p, state["target_indices"], reduction="sum")
                else:
                    raise ValueError(f"unknown embedding loss '{method}'")
                loss = torch.sum(loss * mask) / denom
                loss_dict[f"embed_loss_{method}_{i}"] = loss
                loss_dict["total_loss"] = loss_dict["total_loss"] + loss * weight
        return loss_dict


@register_network("MSMCVQGAN")
class MSMCVQGAN(nn.Module):
    """The v2 autoencoder (msmc_vqgan.py:276-409)."""

    def __init__(
        self,
        in_dim: int,
        n_model_size: int,
        encoder_config: Optional[dict] = None,
        quantizer_config: Optional[dict] = None,
        frame_decoder_config: Optional[dict] = None,
        decoder_config: Optional[dict] = None,
        pred_mel: bool = False,
    ):
        super().__init__()
        enc_cfg = dict(encoder_config or {})
        self.in_linear = Linear(in_dim, n_model_size)
        self.encoder = MultiStageEncoder(in_channels=n_model_size, **enc_cfg)
        self.quantizer = MultiStageQuantizer(
            n_model_size=n_model_size,
            upsample_scales=list(enc_cfg.get("downsample_scales", [1]))[::-1],
            **dict(quantizer_config or {}),
        )
        self.decoder_config = dict(decoder_config or {})
        dec_cfg = dict(self.decoder_config)
        dec_cfg["num_mels"] = n_model_size
        # the decoder family by ``decoder_config._name`` (msmc_vqgan.py:366-374):
        # HifiGANGenerator or ISTFTGenerator
        self.decoder = get_network(dec_cfg.pop("_name", "HifiGANGenerator"))(**dec_cfg)
        self.frame_decoder = (
            FFTBlocks(d_model=n_model_size, **dict(frame_decoder_config))
            if frame_decoder_config is not None else None
        )
        self.mel_predictor = Linear(n_model_size, in_dim) if pred_mel else None

    @property
    def frameshift_ratio(self) -> int:
        return generator_upsample_ratio(self.decoder_config)

    def set_group(self, group):
        """Train data-parallel over ``group`` (the quantizer's statistics)."""
        self.quantizer.set_group(group)

    def _frame_decode(self, decoder_inputs, lengths):
        if self.frame_decoder is None:
            return decoder_inputs
        pos = positions_from_lengths(lengths, decoder_inputs.shape[1])
        return self.frame_decoder(decoder_inputs, pos)[0]

    def analysis(self, mel, mel_length):
        """mel [B, T, in_dim] -> quantizer states (msmc_vqgan.py:352-370)."""
        x = self.in_linear(mel)
        return self.quantizer(self.encoder(x, mel_length))

    def encode_features(self, mel, mel_length):
        """Analysis-synthesis up to (excluding) the HiFi-GAN decoder."""
        q = self.analysis(mel, mel_length)
        return self._frame_decode(q["residual_output"], mel_length)

    def forward(self, mel, mel_length, warmup: bool = False, window_starts=None,
                window_frames: Optional[int] = None):
        """Training / end-to-end forward (``msmc_vqgan.py:395-436``); without
        the extra arguments, in ``eval()`` mode, the analysis-synthesis round
        trip. ``window_starts`` [B] frame offsets with ``window_frames`` crop
        the decoder input per utterance before the waveform decoder;
        ``warmup`` skips that decoder. Per-stage lists are coarsest-first.
        'decoder_diffs' is None outside training mode."""
        encoder_states = self.encoder(self.in_linear(mel), mel_length)
        q = self.quantizer(encoder_states)
        out = dict(
            encoder_outputs=[s[0] for s in encoder_states][::-1],
            encoder_lengths=[s[1] for s in encoder_states][::-1],
            encoder_indices=q["quantizer_indices"],
            encoder_diffs=q["quantizer_diffs"],
            decoder_diffs=q.get("predictor_diffs"),
        )
        decoder_inputs = self._frame_decode(q["residual_output"], mel_length)
        if self.mel_predictor is not None:
            out["mel_outputs"] = self.mel_predictor(decoder_inputs)
        if not warmup:
            if window_starts is not None:
                if window_frames is None:
                    raise ValueError("window_starts needs window_frames")
                decoder_inputs = crop_windows(decoder_inputs, window_starts, window_frames)
            out["decoder_outputs"] = self.decoder(decoder_inputs)
        return out

    def synthesis_features(self, quantizer_outputs, quantizer_lengths):
        """Predicted embeddings (coarsest-first) -> decoder input features:
        nearest-codeword re-quantization, residual chain, frame decoder."""
        stages = list(zip(quantizer_outputs, quantizer_lengths))
        q = self.quantizer(stages, from_encoder=False)
        return self._frame_decode(q["residual_output"], quantizer_lengths[-1])

    def synthesis(self, quantizer_outputs, quantizer_lengths):
        """Predicted embeddings (coarsest-first) -> waveform [B, T*r, 1]
        (msmc_vqgan.py:372-398)."""
        return self.decoder(self.synthesis_features(quantizer_outputs, quantizer_lengths))

    def compute_embedding_loss(self, quantizer_outputs, quantizer_lengths, quantizer_states,
                               methods=("mse",), loss_weights=(1.0,)):
        """The acoustic model's embedding losses (``msmc_vqgan.py:489-508``):
        its coarsest-first predictions against the states of ``analysis``
        (codewords and indices) at the given per-stage lengths."""
        pred_states = [
            dict(
                predictor_outputs=quantizer_outputs[i],
                target_outputs=quantizer_states["quantizer_outputs"][i],
                target_indices=quantizer_states["quantizer_indices"][i],
                target_lengths=quantizer_lengths[i],
            )
            for i in range(len(quantizer_outputs))
        ]
        return self.quantizer.compute_embedding_loss(pred_states, methods, loss_weights)
