"""FastSpeech-style multi-stage acoustic predictor (counterpart of
``msmctts_tpu/models/predictor.py``).

text (phone/tone/erhua embedding sum) -> encoder FFT blocks -> length
regulation to frame rate -> per-stage decoding coarsest-first, each stage
conditioned on the downsampled text and the repeat-upsampled previous
stage. In training the previous stage is the frozen autoencoder's quantizer
output (teacher forcing) and the durations returned are the raw
predictions; at inference it is the previous prediction, snapped to the
autoencoder's codebook through ``ops/vq.py``.
Names follow the reference (``word_emb``, ``encoder``, ``upsampler``,
``downsamplers.i``, ``decoders.i.{0,1,2}``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from msmctts_tpu_torch.models.transformer import FFTBlocks, LengthRegulator
from msmctts_tpu_torch.ops.masking import positions_from_lengths
from msmctts_tpu_torch.ops.vq import vq_nearest_sharded
from msmctts_tpu_torch.parallel.precision import Conv1d, Linear
from msmctts_tpu_torch.registry import register_network


def snap_with_codebook(x, embed):
    """Snap [B, T, D] to nearest codewords of embed [H, d, K] (multi-head)."""
    B, T, D = x.shape
    H = embed.shape[0]
    # fp32 search, codewords back in x's dtype (msmctts_tpu/models/predictor.py:40)
    _, quant = vq_nearest_sharded(x.float().reshape(B * T, H, D // H), embed)
    return quant.reshape(B, T, D).to(x.dtype)


def avg_pool_ceil(x, scale: int):
    if scale == 1:
        return x
    B, T, C = x.shape
    if T % scale:
        raise ValueError(f"{T} % {scale} != 0")
    return x.reshape(B, T // scale, scale, C).mean(dim=2)


@register_network("MultiStagePredictor")
@register_network("NASynCascadeFastSpeech")  # the QS-TTS predictor recipe's name for it
class MultiStagePredictor(nn.Module):
    def __init__(
        self,
        n_symbols,
        n_model_size: int,
        n_pred_size: int,
        n_pred_scale: Sequence[int],
        encoder_config: dict,
        adaptor_config: dict,
        decoder_config: dict,
    ):
        super().__init__()
        syms = n_symbols if isinstance(n_symbols, (list, tuple)) else [n_symbols]
        self.n_symbols = n_symbols  # vocabulary per phone stream (serving draws warmup text from it)
        M = n_model_size
        # one stream is a bare Embedding in the reference, several a list
        if len(syms) == 1:
            self.word_emb = nn.Embedding(int(syms[0]), M)
        else:
            self.word_emb = nn.ModuleList(nn.Embedding(int(n), M) for n in syms)
        enc_cfg = dict(encoder_config)
        enc_cfg.pop("name", None)
        enc_cfg.setdefault("d_model", M)
        self.encoder = FFTBlocks(**enc_cfg)
        self.upsampler = LengthRegulator(**dict(adaptor_config))
        self.n_pred_scale = list(n_pred_scale)
        # downsamplers iterate fine->coarse (scales reversed)
        self.downsamplers = nn.ModuleList(
            Conv1d(M, M, 2 * s + 1, padding=s) for s in self.n_pred_scale[::-1]
        )
        dec_cfg = dict(decoder_config)
        dec_cfg.pop("name", None)
        dec_cfg.setdefault("d_model", M)
        self.decoders = nn.ModuleList(
            nn.ModuleList([
                Linear(M if i == 0 else 2 * M + n_pred_size, M),
                FFTBlocks(**dec_cfg),
                Linear(M, n_pred_size),
            ])
            for i in range(len(self.n_pred_scale))
        )

    def embed_text(self, text):
        """Summed multi-stream embedding with zeroed padding rows."""
        if text.dim() == 2:
            text = text[..., None]
        embs = self.word_emb if isinstance(self.word_emb, nn.ModuleList) else [self.word_emb]
        out = None
        for i, emb in enumerate(embs):
            ids = text[..., i].long()
            # summed in fp32: under bf16 the JAX package's sum is a bf16 add
            # that only the fp32 position table reads, and XLA (its default
            # allow_excess_precision) never rounds it in between
            e = (emb(ids) * (ids != 0)[..., None]).float()
            out = e if out is None else out + e
        return out

    def _encode(self, text, text_length):
        x = self.embed_text(text)
        return self.encoder(x, positions_from_lengths(text_length, x.shape[1]))

    def forward(
        self,
        text,
        text_length,
        max_frames: Optional[int] = None,
        dur: Optional[torch.Tensor] = None,
        feat: Optional[List[torch.Tensor]] = None,
        feat_length: Optional[List[torch.Tensor]] = None,
        codebooks: Optional[List[torch.Tensor]] = None,
    ):
        """Returns {'feat': coarsest-first predictions, 'feat_length',
        'text_length', 'duration'}.

        Training (``train()`` mode): ``dur`` and the teacher's coarsest-first
        ``feat`` (with its per-stage ``feat_length``, used as given);
        ``max_frames`` defaults to the teacher's fine length, and 'duration'
        holds the raw predictions. Inference: ``max_frames`` bounds the
        expansion; ``dur`` forces the durations; ``codebooks``
        (coarsest-first [H, d, K]) enable per-stage snapping."""
        x, text_mask = self._encode(text, text_length)
        if max_frames is None:
            if feat is None:
                raise ValueError("max_frames required when no teacher features are given")
            max_frames = feat[-1].shape[1]
        x, total_length, _, duration = self.upsampler(x, text_mask, max_out_len=max_frames, target=dur)
        if feat_length is None:  # per-stage lengths, ceil-cumulative (fine -> coarse)
            feat_length, total = [], total_length
            for scale in self.n_pred_scale[::-1]:
                total = (total + scale - 1) // scale
                feat_length.append(total)
            feat_length = feat_length[::-1]
        preds = self.decode(x, feat, feat_length, codebooks=codebooks)
        return dict(feat=preds, feat_length=feat_length, text_length=text_length, duration=duration)

    @torch.no_grad()
    def bias_durations(self, frames_per_symbol: float):
        """Set the duration head's output bias to ``frames_per_symbol``: a
        freshly initialized predictor emits ~0 durations, so smoke and bench
        runs would carry no frame load."""
        self.upsampler.duration_predictor.linear_layer.bias.fill_(float(frames_per_symbol))

    def predict_durations(self, text, text_length):
        """Phase-1 inference: rounded, clamped per-phone durations (float)."""
        x, text_mask = self._encode(text, text_length)
        dur = self.upsampler.duration_predictor(x, text_mask)
        return torch.round(torch.clamp(dur.float(), min=0.0))  # fp32 durations (predictor.py:207)

    def decode(self, text_embedding, feat, feat_lengths, codebooks=None):
        """Per-stage cascade: stage i > 0 is fed the teacher's ``feat[i - 1]``
        when ``feat`` is given, else the previous stage's prediction."""
        downsampled = []
        h = text_embedding
        for conv, scale in zip(self.downsamplers, self.n_pred_scale[::-1]):
            h = conv(h.transpose(1, 2)).transpose(1, 2)
            h = avg_pool_ceil(h, scale)
            downsampled.append(h)
        downsampled = downsampled[::-1]

        preds, output = [], None
        for i, (pre_linear, blocks, out_linear) in enumerate(self.decoders):
            text_emb = downsampled[i]
            pos = positions_from_lengths(feat_lengths[i], text_emb.shape[1])
            if i > 0:
                prev = torch.cat([output, feat[i - 1] if feat is not None else preds[-1]], dim=-1)
                prev = torch.repeat_interleave(prev, self.n_pred_scale[i - 1], dim=1)[:, : text_emb.shape[1]]
                stage_in = torch.cat([text_emb, prev], dim=-1)
            else:
                stage_in = text_emb
            output, _ = blocks(pre_linear(stage_in), pos)
            prediction = out_linear(output)
            if codebooks is not None:
                prediction = snap_with_codebook(prediction, codebooks[i])
            preds.append(prediction)
        return preds
