"""The QS-TTS embedding-input VQ-GAN family (counterpart of
``msmctts_tpu/models/msmc_vqgan_emb.py``).

  * ``MAMSEncoder``: per-stage FFT blocks over SSL embeddings with a conv
    pitch / energy encoder added after each stage's transformer; the content
    representation is tapped at stage 0, before the pitch is added; the
    pitch encoding is average-pooled along with the features.
  * ``MSMCVQGANEmb``: in_linear -> MAMS -> ``MultiStageQuantizer`` ->
    optional ECAPA-TDNN global speaker embedding added to the decoder
    inputs (from ``mel`` when no ``ref`` is given) -> frame decoder -> mel
    head (``mel_dim`` may differ from the input) -> HiFi-GAN, whose MRF
    layers run through ``ops/resblock.py`` in ``eval()`` mode. Windowed
    decode takes per-window starts and, with ``window_indices``, first
    selects the sub-batch of rows the windows come from (one row may give
    several windows).
  * ``AttrPredictor``: ResStack + 1x1 head, the adversarial prosody
    estimator of ``EmbVQGANTrainer``.
  * ``KMeansQuantizer`` / ``KMeansVQGANEmb``: frozen k-means centroids as one
    single-head codebook that never moves. Its nearest-centroid search is
    plain PyTorch (matmul + argmin) on the card too: the JAX package computes
    it with the plain ``nearest_codes``, outside any Pallas kernel, and at
    d = 1024 with hundreds of centroids the codebook is far beyond the snap
    kernel's shared memory (``ops/vq.shared_bytes``).
  * ``EmbVC``: continuous bottleneck (the coarsest encoder output), no
    quantizer.

``train()`` mode is the JAX package's ``deterministic=False`` with mutable
``codebook`` and ``batch_stats`` collections: dropout draws, the codebook
EMA moves, the ECAPA batch norms use and update batch statistics.
Parameter names follow the JAX modules' (``in_linear``, ``encoder.encoders.i``,
``encoder.pitch_encoder`` as a ``Sequential`` of convs at 0 / 2 / 4 / 6,
``quantizer``, ``global_encoder``, ``frame_decoder``, ``mel_predictor``,
``decoder``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from msmctts_tpu_torch.models.hifigan import generator_upsample_ratio
from msmctts_tpu_torch.models.modules import ResStack
from msmctts_tpu_torch.models.msmc_vqgan import MultiStageQuantizer, _ceil_div, avg_pool_1d, crop_windows
from msmctts_tpu_torch.models.quantizer import codebook_distances, lookup_codes
from msmctts_tpu_torch.models.tdnn import ECAPA_TDNN
from msmctts_tpu_torch.models.transformer import FFTBlocks
from msmctts_tpu_torch.ops.masking import positions_from_lengths, sequence_mask
from msmctts_tpu_torch.parallel.precision import Conv1d, Linear
from msmctts_tpu_torch.registry import get_network, register_network


def load_kmeans_centroids(path: str) -> np.ndarray:
    """[K, dim] centroids from a sklearn-KMeans pickle or a raw .npy."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    import pickle

    with open(path, "rb") as f:
        model = pickle.load(f)
    centers = getattr(model, "cluster_centers_", model)
    return np.asarray(centers, np.float32)


@register_network("AttrPredictor")
class AttrPredictor(nn.Module):
    """ResStack + 1x1 head predicting frame attributes (pitch / energy) from
    hidden states [B, T, in_channels] -> (hidden, masked prediction).

    The JAX package applies it deterministically wherever it runs it (the
    trainer's estimator and generator terms), so its ResStack is built
    without dropout: the same function, and the weights stay live for the
    estimator's own gradient in ``train()`` mode."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5, dilation_rate: int = 1,
                 n_layers: int = 4):
        super().__init__()
        self.enc = ResStack(in_channels, kernel_size, dilation_rate, n_layers, p_dropout=0.0)
        self.proj = Linear(in_channels, out_channels)

    def forward(self, x, lengths):
        mask = sequence_mask(lengths, x.shape[1], dtype=x.dtype)[..., None]
        h = self.enc(x, mask)
        return h, self.proj(h) * mask


class MAMSEncoder(nn.Module):
    """Multi-attribute multi-stage encoder: returns (fine-to-coarse
    [(feat, length)], content representation of stage 0)."""

    def __init__(
        self,
        in_channels: int,
        pitch_dim: int = 1,
        energy_dim: int = 1,
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
        C = in_channels
        self.pitch_encoder = None
        if pitch_dim + energy_dim > 0:  # conv7-tanh-conv3-tanh-conv3-tanh-conv1
            self.pitch_encoder = nn.Sequential(
                Conv1d(pitch_dim + energy_dim, C, 7, padding=3), nn.Tanh(),
                Conv1d(C, C, 3, padding=1), nn.Tanh(),
                Conv1d(C, C, 3, padding=1), nn.Tanh(),
                Conv1d(C, C, 1),
            )
        self.encoders = nn.ModuleList(
            FFTBlocks(
                max_seq_len=max_seq_len, n_layers=n_layers, n_head=n_head, d_k=d_k, d_v=d_v, d_model=C,
                d_inner=d_inner, fft_conv1d_kernel=fft_conv1d_kernel, dropout=dropout, attn_dropout=attn_dropout,
            )
            for _ in self.downsample_scales
        )

    def forward(self, emb, input_length, pitch=None, energy=None):
        use_pitch = self.pitch_encoder is not None and pitch is not None
        if use_pitch:
            pe = torch.cat([pitch, energy], dim=-1)
            pitch_encoding = self.pitch_encoder(pe.transpose(1, 2)).transpose(1, 2)
        outputs, content = [], None
        feat, feat_length = emb, input_length
        for i, (scale, encoder) in enumerate(zip(self.downsample_scales, self.encoders)):
            if scale > 1:
                feat = avg_pool_1d(feat, scale)
                if use_pitch:
                    pitch_encoding = avg_pool_1d(pitch_encoding, scale)
                feat_length = _ceil_div(feat_length, scale)
            feat, _ = encoder(feat, positions_from_lengths(feat_length, feat.shape[1]))
            if i == 0:
                content = feat  # the content representation, before the pitch
            if use_pitch:
                feat = feat + pitch_encoding
            outputs.append((feat, feat_length))
        return outputs, content


class _EmbAutoencoder(nn.Module):
    """The decoder tail the family shares: global speaker embedding, frame
    decoder, mel head and the (windowed) HiFi-GAN decode."""

    def _build_tail(self, emb_dim, n_model_size, global_encoder_config, frame_decoder_config, decoder_config,
                    pred_mel, mel_dim):
        if global_encoder_config is not None:
            name = dict(global_encoder_config).get("_name", "ECAPA_TDNN")
            if name != "ECAPA_TDNN":
                raise ValueError(f"unknown global encoder {name}")
            self.global_encoder = ECAPA_TDNN(in_channels=mel_dim or emb_dim, embd_dim=n_model_size,
                                             channels=n_model_size)
        else:
            self.global_encoder = None
        self.decoder_config = dict(decoder_config or {})
        dec_cfg = dict(self.decoder_config)
        dec_cfg["num_mels"] = n_model_size
        dec_name = dec_cfg.pop("_name", "HifiGANGenerator")
        if dec_name != "HifiGANGenerator":
            raise NotImplementedError(f"decoder '{dec_name}' is not ported (only HifiGANGenerator)")
        self.decoder = get_network(dec_name)(**dec_cfg)
        self.frame_decoder = (
            FFTBlocks(d_model=n_model_size, **dict(frame_decoder_config))
            if frame_decoder_config is not None else None
        )
        self.mel_predictor = Linear(n_model_size, mel_dim or emb_dim) if pred_mel else None

    @property
    def frameshift_ratio(self) -> int:
        return generator_upsample_ratio(self.decoder_config)

    def set_group(self, group):
        """Train data-parallel over ``group``: codebook statistics and BN
        statistics cover every rank's rows."""
        if getattr(self, "quantizer", None) is not None and hasattr(self.quantizer, "set_group"):
            self.quantizer.set_group(group)
        if self.global_encoder is not None:
            self.global_encoder.set_group(group)

    def _global_embed(self, ref, train: bool):
        if self.global_encoder is None:
            return None
        if ref is None:
            raise ValueError("the global speaker encoder needs a reference: pass mel (or ref)")
        return self.global_encoder(ref, train=train)[:, None, :]

    def _frame_decode(self, decoder_inputs, lengths):
        if self.frame_decoder is None:
            return decoder_inputs
        return self.frame_decoder(decoder_inputs, positions_from_lengths(lengths, decoder_inputs.shape[1]))[0]

    def _decode_tail(self, out, decoder_inputs, lengths, window_starts, window_frames, window_indices, decode):
        decoder_inputs = self._frame_decode(decoder_inputs, lengths)
        if self.mel_predictor is not None:
            out["mel_outputs"] = self.mel_predictor(decoder_inputs)
        if decode:
            if window_starts is not None:
                if window_frames is None:
                    raise ValueError("window_starts needs window_frames")
                if window_indices is not None:  # the sub-batch the windows come from
                    decoder_inputs = decoder_inputs[window_indices.long()]
                decoder_inputs = crop_windows(decoder_inputs, window_starts, window_frames)
            out["decoder_outputs"] = self.decoder(decoder_inputs)
        return out


@register_network("MSMCVQGANEmb")
class MSMCVQGANEmb(_EmbAutoencoder):
    def __init__(
        self,
        emb_dim: int,
        n_model_size: int,
        pitch_dim: int = 1,
        energy_dim: int = 1,
        encoder_config: Optional[dict] = None,
        quantizer_config: Optional[dict] = None,
        global_encoder_config: Optional[dict] = None,
        frame_decoder_config: Optional[dict] = None,
        decoder_config: Optional[dict] = None,
        pred_mel: bool = False,
        mel_dim: Optional[int] = None,
    ):
        super().__init__()
        enc_cfg = dict(encoder_config or {})
        self.in_linear = Linear(emb_dim, n_model_size)
        self.encoder = MAMSEncoder(in_channels=n_model_size, pitch_dim=pitch_dim, energy_dim=energy_dim, **enc_cfg)
        self.quantizer = MultiStageQuantizer(
            n_model_size=n_model_size,
            upsample_scales=list(enc_cfg.get("downsample_scales", [1]))[::-1],
            **dict(quantizer_config or {}),
        )
        self._build_tail(emb_dim, n_model_size, global_encoder_config, frame_decoder_config, decoder_config,
                         pred_mel, mel_dim)

    def _encode(self, emb, emb_length, pitch, energy):
        encoder_states, content = self.encoder(self.in_linear(emb), emb_length, pitch, energy)
        return encoder_states, content, self.quantizer(encoder_states)

    def forward(self, emb, emb_length, pitch=None, energy=None, mel=None, ref=None, decode: bool = True,
                window_starts=None, window_frames: Optional[int] = None, window_indices=None):
        """Training / end-to-end forward (``msmc_vqgan_emb.py:232-281``);
        per-stage lists coarsest-first; 'decoder_diffs' is None outside
        training mode."""
        encoder_states, content, q = self._encode(emb, emb_length, pitch, energy)
        out = dict(
            encoder_outputs=[s[0] for s in encoder_states][::-1],
            encoder_lengths=[s[1] for s in encoder_states][::-1],
            content_representations=content,
            encoder_indices=q["quantizer_indices"],
            encoder_diffs=q["quantizer_diffs"],
            decoder_diffs=q.get("predictor_diffs"),
        )
        decoder_inputs = q["residual_output"]
        g = self._global_embed(mel if ref is None else ref, self.training)
        if g is not None:
            decoder_inputs = decoder_inputs + g
        return self._decode_tail(out, decoder_inputs, emb_length, window_starts, window_frames, window_indices, decode)

    def analysis(self, emb, emb_length, pitch=None, energy=None):
        """emb -> quantizer states; in training mode also the encoder's
        outputs and the content representation."""
        encoder_states, content, q = self._encode(emb, emb_length, pitch, energy)
        if not self.training:
            return q
        return dict(
            encoder_outputs=[s[0] for s in encoder_states][::-1],
            encoder_lengths=[s[1] for s in encoder_states][::-1],
            encoder_indices=q["quantizer_indices"],
            encoder_diffs=q["quantizer_diffs"],
            decoder_diffs=q.get("predictor_diffs"),
            quantizer_states=q,
            content_representations=content,
        )

    def synthesis_features(self, quantizer_outputs, quantizer_lengths, ref=None):
        """Coarsest-first embeddings -> the HiFi-GAN decoder's input:
        re-quantization, residual chain, the speaker embedding of ``ref``
        (running BN statistics) where given, frame decoder. The JAX class
        has no such method; ``synthesis`` is the decoder on it, which the
        task's ``predict`` runs (``msmctts_tpu/tasks.py:785``)."""
        q = self.quantizer(list(zip(quantizer_outputs, quantizer_lengths)), from_encoder=False)
        decoder_inputs = q["residual_output"]
        if ref is not None:
            decoder_inputs = decoder_inputs + self._global_embed(ref, False)
        return self._frame_decode(decoder_inputs, quantizer_lengths[-1])

    def synthesis(self, quantizer_outputs, quantizer_lengths, ref=None):
        """Coarsest-first embeddings -> waveform [B, T*r, 1]."""
        return self.decoder(self.synthesis_features(quantizer_outputs, quantizer_lengths, ref))

    def compute_embedding_loss(self, quantizer_outputs, quantizer_lengths, quantizer_states,
                               methods=("mse",), loss_weights=(1.0,)):
        """The predictor's embedding losses against ``analysis``'s states."""
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


class KMeansQuantizer(nn.Module):
    """Frozen single-codebook quantizer: ``embed`` [1, d, K] holds the
    centroids and never moves. The search is plain PyTorch (see the module
    docstring), in the JAX package's order of operations."""

    def __init__(self, model_path: str):
        super().__init__()
        centroids = load_kmeans_centroids(model_path)  # [K, d]
        self.register_buffer("embed", torch.from_numpy(np.ascontiguousarray(centroids.T[None])))

    def forward(self, stages: List[Tuple[torch.Tensor, torch.Tensor]]):
        quant_outputs, quant_diffs, quant_indices, lengths = [], [], [], []
        for embedding, length in stages:
            B, T, D = embedding.shape
            dist = codebook_distances(embedding.reshape(B, T, 1, D), self.embed)  # [B, T, 1, K]
            idx = torch.argmin(dist, dim=-1)  # the first minimum wins, as jnp.argmin
            quant = lookup_codes(idx, self.embed).reshape(B, T, D).to(embedding.dtype)
            quant_diffs.append(torch.square(quant.detach().float() - embedding.float()))
            quant_outputs.append(embedding + (quant - embedding).detach())
            quant_indices.append(idx[..., 0].to(torch.int32))
            lengths.append(length)
        return dict(residual_output=None, quantizer_outputs=quant_outputs, quantizer_diffs=quant_diffs,
                    quantizer_indices=quant_indices, quantizer_lengths=lengths, predictor_diffs=None)


@register_network("KMeansVQGANEmb")
class KMeansVQGANEmb(_EmbAutoencoder):
    """Decoder-only VQ-GAN around frozen k-means codewords
    (``msmc_vqgan_emb.py:344-459``)."""

    def __init__(
        self,
        emb_dim: int,
        n_model_size: int,
        quantizer_path: str = "",
        global_encoder_config: Optional[dict] = None,
        frame_decoder_config: Optional[dict] = None,
        decoder_config: Optional[dict] = None,
        pred_mel: bool = False,
        mel_dim: Optional[int] = None,
    ):
        super().__init__()
        self.quantizer = KMeansQuantizer(quantizer_path)
        self.in_linear = Linear(emb_dim, n_model_size)
        self._build_tail(emb_dim, n_model_size, global_encoder_config, frame_decoder_config, decoder_config,
                         pred_mel, mel_dim)

    def forward(self, emb, emb_length, pitch=None, energy=None, mel=None, ref=None, decode: bool = True,
                window_starts=None, window_frames: Optional[int] = None, window_indices=None):
        q = self.quantizer([(emb, emb_length)])
        decoder_inputs = self.in_linear(q["quantizer_outputs"][-1])
        out = {"encoder_indices": q["quantizer_indices"]}
        g = self._global_embed(mel if ref is None else ref, self.training)
        if g is not None:
            decoder_inputs = decoder_inputs + g
        return self._decode_tail(out, decoder_inputs, emb_length, window_starts, window_frames, window_indices, decode)

    def analysis(self, emb, emb_length):
        return self.quantizer([(emb, emb_length)])

    def synthesis(self, quantizer_outputs, quantizer_lengths, ref=None):
        q = self.quantizer(list(zip(quantizer_outputs, quantizer_lengths)))
        decoder_inputs = self.in_linear(q["quantizer_outputs"][-1])
        if ref is not None:
            decoder_inputs = decoder_inputs + self._global_embed(ref, False)
        return self._decode_tail({}, decoder_inputs, quantizer_lengths[-1], None, None, None, True)["decoder_outputs"]


@register_network("EmbVC")
class EmbVC(_EmbAutoencoder):
    """Voice conversion: the coarsest encoder output as a continuous
    bottleneck, no quantizer (``msmc_vqgan_emb.py:462-540``)."""

    def __init__(
        self,
        emb_dim: int,
        n_model_size: int,
        pitch_dim: int = 1,
        energy_dim: int = 1,
        encoder_config: Optional[dict] = None,
        global_encoder_config: Optional[dict] = None,
        frame_decoder_config: Optional[dict] = None,
        decoder_config: Optional[dict] = None,
        pred_mel: bool = False,
        mel_dim: Optional[int] = None,
    ):
        super().__init__()
        self.quantizer = None
        self.in_linear = Linear(emb_dim, n_model_size)
        self.encoder = MAMSEncoder(in_channels=n_model_size, pitch_dim=pitch_dim, energy_dim=energy_dim,
                                   **dict(encoder_config or {}))
        self._build_tail(emb_dim, n_model_size, global_encoder_config, frame_decoder_config, decoder_config,
                         pred_mel, mel_dim)

    def forward(self, emb, emb_length, pitch=None, energy=None, mel=None, ref=None, decode: bool = True,
                window_starts=None, window_frames: Optional[int] = None, window_indices=None):
        encoder_states, content = self.encoder(self.in_linear(emb), emb_length, pitch, energy)
        out = dict(
            encoder_outputs=[s[0] for s in encoder_states][::-1],
            encoder_lengths=[s[1] for s in encoder_states][::-1],
            content_representations=content,
        )
        decoder_inputs = encoder_states[-1][0]
        g = self._global_embed(mel if ref is None else ref, self.training)
        if g is not None:
            decoder_inputs = decoder_inputs + g
        return self._decode_tail(out, decoder_inputs, emb_length, window_starts, window_frames, window_indices, decode)
