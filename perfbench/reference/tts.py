"""Plain PyTorch reference of the two-stage MSMC-TTS model at inference.

text -> ``MultiStagePredictor`` (phone / tone / erhua embeddings, FFT
blocks, duration head, length regulator, a coarsest-first cascade of stages
each snapped to the autoencoder's codebook) -> the autoencoder's
``synthesis`` (re-quantization, the residual chain with its prior
predictors, the frame decoder) -> the HiFi-GAN decoder (transposed convs and
the MRF blocks) -> waveform, as hhguo/MSMC-TTS computes them.

It is written from the model's equations with plain ``torch`` operations and
imports nothing of the program under test: no kernel, no cache, no
batching. Weights come as one dict of tensors, keyed by the published
module names (``predictor.encoder.layer_stack.0.slf_attn.linear.weight``,
``autoencoder.decoder.resblocks.0.convs1.0.weight_v``, ...), which the
benchmark draws from its seed and hands to both sides.

Served choices are judged, not followed blindly: :func:`forward` takes the
durations and codewords a run served (the "tokens" of a TTS model) and
returns, beside its own waveform decoded from them, the continuous values
each choice was made from (the duration head's output, every codeword
distance), so that a judge can read how far a served choice lies from the
reference's best.

In training (``perfbench/reference/vqgan_train.py``) dropout is on:
:meth:`Reference._drop` draws each mask as the program's ``ops/dropout.py``
documents it, one ``bernoulli_`` over the whole batch from one seeded
generator, in the model's call order. At inference it is the identity.

``precision="fp32"`` computes every product in float32 with TF32 off.
``precision="tf32"`` rounds both operands of every matrix product and
convolution to TF32 (10 mantissa bits, round to nearest even) before an
fp32 product: the lower precision a later change could be tempted by, used
as the comparison's control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

LAYERNORM_EPS = 1e-5
NEG_INF = -1e9
HIFIGAN_SLOPE = 0.1  # leaky ReLU inside the generator and its MRF blocks
POST_SLOPE = 0.01  # torch's default slope before conv_post (hifigan generator.py)


def exact_fp32() -> None:
    """fp32 products: cuBLAS and cuDNN would otherwise take TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits), ties
    to even, kept in float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


class Ops:
    """The products of one precision: every matmul and conv goes through here."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.low = precision == "tf32"

    def r(self, t):
        """TF32 operands: the rounded value, with the gradient of the identity."""
        if not self.low or t is None:
            return t
        rounded = tf32_round(t.detach())
        return rounded if not t.requires_grad else t + (rounded - t).detach()

    def linear(self, x, w, b=None):
        return F.linear(self.r(x), self.r(w), b)

    def conv1d(self, x, w, b=None, padding=0, dilation=1):
        return F.conv1d(self.r(x), self.r(w), b, padding=padding, dilation=dilation)

    def conv_transpose1d(self, x, w, b, stride, padding):
        return F.conv_transpose1d(self.r(x), self.r(w), b, stride=stride, padding=padding)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.r(a), self.r(b))


def weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``v / max(||v||, 1e-12) * g``, the norm over every axis but the first."""
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))
    return v / torch.clamp(norm, min=1e-12) * g


def position_table(n_position: int, d: int, device) -> torch.Tensor:
    """Sinusoid table [n_position, d], row 0 (padding) zero."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    dim = np.arange(d, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (dim // 2) / d)
    table = np.where(dim % 2 == 0, np.sin(angle), np.cos(angle))
    table[0] = 0.0
    return torch.from_numpy(table.astype(np.float32)).to(device)


def positions(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """1-based positions [B, T], 0 past each length."""
    t = torch.arange(1, T + 1, device=lengths.device)[None, :]
    return t * (t <= lengths[:, None]).long()


class Reference:
    """The model over one weight dict ``W`` and the configuration's
    ``task`` node (``predictor`` and ``autoencoder``)."""

    def __init__(self, W: Dict[str, torch.Tensor], task: dict, precision: str = "fp32"):
        exact_fp32()  # "tf32" rounds operands itself; no product may round them otherwise
        self.W = W
        self.pcfg = task["predictor"]
        self.acfg = task["autoencoder"]
        self.ops = Ops(precision)
        self._tables: Dict[tuple, torch.Tensor] = {}
        self.gen: Optional[torch.Generator] = None  # dropout's masks are drawn from it; None: no dropout

    def _drop(self, x, rate: float):
        """Inverted dropout: a keep mask the shape of ``x`` drawn from
        ``gen`` by ``bernoulli_(1 - rate)``, kept values scaled by
        ``1 / (1 - rate)``."""
        if self.gen is None or rate <= 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.empty(x.shape, dtype=x.dtype, device=x.device).bernoulli_(keep, generator=self.gen)
        return x * mask / keep

    # -------------------------------------------------------------- blocks
    def _w(self, name):
        return self.W[name]

    def _ln(self, x, p):
        return F.layer_norm(x, x.shape[-1:], self._w(p + ".weight"), self._w(p + ".bias"), LAYERNORM_EPS)

    def _lin(self, x, p):
        return self.ops.linear(x, self._w(p + ".weight"), self._w(p + ".bias"))

    def _conv(self, x, p, padding, dilation=1):
        """Plain conv over [B, C, T]."""
        return self.ops.conv1d(x, self._w(p + ".weight"), self._w(p + ".bias"), padding, dilation)

    def _wnconv(self, x, p, padding, dilation=1):
        """Weight-normalized conv over [B, C, T]."""
        w = weight_norm(self._w(p + ".weight_v"), self._w(p + ".weight_g"))
        return self.ops.conv1d(x, w, self._w(p + ".bias"), padding, dilation)

    def _conv1x1(self, x, p):
        """1x1 conv over [B, T, C]."""
        return self.ops.linear(x, self._w(p + ".weight")[:, :, 0], self._w(p + ".bias"))

    def fft_blocks(self, x, pos, p, cfg):
        """FFT blocks over [B, T, d]: positions, then per layer masked
        self-attention and a conv FFN, each with a residual and a LayerNorm;
        dropout on the attention weights, the attention's output and the
        FFN's output."""
        d = x.shape[-1]
        key = (cfg["max_seq_len"] + 1, d)
        if key not in self._tables:
            self._tables[key] = position_table(*key, x.device)
        pos = torch.clamp(pos, 0, cfg["max_seq_len"])
        x = x + self._tables[key][pos]
        key_pad = pos == 0
        non_pad = (pos != 0)[..., None].float()
        H, dk, dv = cfg["n_head"], cfg["d_k"], cfg["d_v"]
        k = cfg.get("fft_conv1d_kernel", 3)
        rate, attn_rate = cfg.get("dropout", 0.1), cfg.get("attn_dropout", 0.1)
        B, T, _ = x.shape
        for i in range(cfg["n_layers"]):
            q = f"{p}.layer_stack.{i}"
            qkv = self._lin(x, q + ".slf_attn.linear").view(B, T, H, 2 * dk + dv)
            qh, kh, vh = qkv[..., :dk], qkv[..., dk : 2 * dk], qkv[..., 2 * dk :]
            attn = self.ops.einsum("bqhd,bkhd->bhqk", qh, kh) * (1.0 / math.sqrt(dk))
            attn = torch.softmax(attn.masked_fill(key_pad[:, None, None, :], NEG_INF), dim=-1)
            attn = self._drop(attn, attn_rate)
            out = self.ops.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(B, T, H * dv)
            y = self._drop(self._lin(out, q + ".slf_attn.fc"), rate)
            x = self._ln(y + x, q + ".slf_attn.layer_norm") * non_pad
            h = self._conv(x.transpose(1, 2), q + ".pos_ffn.w_1", (k - 1) // 2)
            h = self._conv(F.relu(h), q + ".pos_ffn.w_2", (k - 1) // 2).transpose(1, 2)
            x = self._ln(self._drop(h, rate) + x, q + ".pos_ffn.layer_norm") * non_pad
        return x, non_pad

    # ----------------------------------------------------------- predictor
    def encode_text(self, text, text_length):
        """text [B, L, S] ids (0 = padding) -> encoder output, non_pad."""
        x = None
        for s in range(text.shape[-1]):
            ids = text[..., s]
            name = "predictor.word_emb.weight" if text.shape[-1] == 1 else f"predictor.word_emb.{s}.weight"
            e = self._w(name)[ids] * (ids != 0)[..., None]
            x = e if x is None else x + e
        return self.fft_blocks(x, positions(text_length, text.shape[1]), "predictor.encoder",
                               self.pcfg["encoder_config"])

    def durations(self, x, non_pad):
        """The duration head's continuous output [B, L] (before clamp and rounding)."""
        p = "predictor.upsampler.duration_predictor"
        k = self.pcfg["adaptor_config"].get("duration_predictor_kernel_size", 3)
        h = x * non_pad
        h = F.relu(self._conv(h.transpose(1, 2), p + ".conv1d_1", (k - 1) // 2)).transpose(1, 2)
        h = self._ln(h, p + ".layer_norm_1")
        h = F.relu(self._conv(h.transpose(1, 2), p + ".conv1d_2", (k - 1) // 2)).transpose(1, 2)
        h = self._ln(h, p + ".layer_norm_2")
        return (self._lin(h, p + ".linear_layer") * non_pad)[..., 0]

    @staticmethod
    def regulate(x, durations, frames: int):
        """Expand phones [B, L, D] by integer durations to [B, frames, D]:
        frame t takes the phone whose cumulative duration first exceeds t."""
        ends = torch.cumsum(durations.long(), dim=-1)
        t = torch.arange(frames, device=x.device)
        idx = torch.clamp(torch.searchsorted(ends, t.expand(x.shape[0], -1).contiguous(), right=True),
                          max=x.shape[1] - 1)
        out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
        return out * (t[None, :] < ends[:, -1:])[..., None].float(), ends[:, -1]

    def codebook(self, stage: int) -> torch.Tensor:
        return self._w(f"autoencoder.quantizer.quantizer.{stage}.embed")  # [H, d, K]

    def distances(self, x, stage: int):
        """x [B, T, H * d] -> squared distances [B, T, H, K] to the stage's
        codewords, and |x|^2 + |e|^2 beside them (their scale)."""
        E = self.codebook(stage)
        H, d, K = E.shape
        xh = x.reshape(*x.shape[:-1], H, d)
        x_sq = torch.sum(xh * xh, dim=-1, keepdim=True)
        e_sq = torch.sum(E * E, dim=1)
        dist = x_sq - 2.0 * self.ops.einsum("bthd,hdk->bthk", xh, E) + e_sq
        return dist, x_sq + e_sq

    def lookup(self, idx, stage: int):
        """indices [B, T, H] -> codewords [B, T, H * d]."""
        E = self.codebook(stage)
        table = E.transpose(1, 2)  # [H, K, d]
        heads = torch.arange(E.shape[0], device=E.device)
        q = table[heads, idx.long()]
        return q.reshape(*idx.shape[:-1], -1)

    def cascade(self, x, total, frames: int, served_idx: Optional[List[torch.Tensor]] = None):
        """The per-stage decoder over the regulated text [B, frames, M].
        Each stage's prediction is judged by its distances and then replaced
        by the codewords of ``served_idx`` (the run's), or of the nearest
        codeword where none are given. -> (per-stage dict, stage lengths)."""
        scales = list(self.pcfg["n_pred_scale"])
        dcfg = self.pcfg["decoder_config"]
        lengths, t = [], total
        for s in scales[::-1]:
            t = (t + s - 1) // s
            lengths.append(t)
        lengths = lengths[::-1]
        down, h = [], x
        for j, s in enumerate(scales[::-1]):
            h = self._conv(h.transpose(1, 2), f"predictor.downsamplers.{j}", s).transpose(1, 2)
            if s > 1:
                B, T, C = h.shape
                h = h.reshape(B, T // s, s, C).mean(dim=2)
            down.append(h)
        down = down[::-1]
        stages, output, prev = [], None, None
        for i in range(len(scales)):
            p = f"predictor.decoders.{i}"
            text_emb = down[i]
            if i == 0:
                stage_in = text_emb
            else:
                cat = torch.repeat_interleave(torch.cat([output, prev], dim=-1), scales[i - 1], dim=1)
                stage_in = torch.cat([text_emb, cat[:, : text_emb.shape[1]]], dim=-1)
            output, _ = self.fft_blocks(self._lin(stage_in, p + ".0"), positions(lengths[i], text_emb.shape[1]),
                                        p + ".1", dcfg)
            pred = self._lin(output, p + ".2")
            dist, scale = self.distances(pred, i)
            idx = served_idx[i] if served_idx is not None else torch.argmin(dist, dim=-1)
            prev = self.lookup(idx, i)
            stages.append({"pred": pred, "dist": dist, "scale": scale, "idx": idx, "quant": prev})
        return stages, lengths

    # --------------------------------------------------------- autoencoder
    def _res_stack(self, x, mask, p, cfg):
        """Gated residual stack over [B, T, C] with a [B, T, 1] mask; dropout
        on each layer's gated activations [B, C, T]."""
        C = x.shape[-1]
        k, rate, n = cfg.get("kernel_size", 5), cfg.get("dilation_rate", 1), cfg.get("n_layers", 4)
        p_drop = cfg.get("p_dropout", 0.1)
        h, m = x.transpose(1, 2), mask.transpose(1, 2)
        out = torch.zeros_like(h)
        for i in range(n):
            d = rate**i
            x_in = self._wnconv(h, f"{p}.in_layers.{i}", (k * d - d) // 2, d)
            acts = self._drop(torch.tanh(x_in[:, :C]) * torch.sigmoid(x_in[:, C:]), p_drop)
            rs = self._wnconv(acts, f"{p}.res_skip_layers.{i}", 0)
            if i < n - 1:
                h = (h + rs[:, :C]) * m
                out = out + rs[:, C:]
            else:
                out = out + rs
        return (out * m).transpose(1, 2)

    def synthesis_features(self, quant: List[torch.Tensor], lengths: List[torch.Tensor]):
        """Coarsest-first codewords -> the frame decoder's output [B, F, M]:
        every stage re-quantized, the residual chain (prior predictors,
        post-processors, upsampling by repetition), the frame decoder."""
        qcfg = self.acfg["quantizer_config"]
        scales = list(self.acfg["encoder_config"]["downsample_scales"])[::-1]
        residual = None
        for i, (emb, length) in enumerate(zip(quant, lengths)):
            T = emb.shape[1]
            mask = (torch.arange(T, device=emb.device)[None, :] < length[:, None]).float()[..., None]
            if residual is not None:
                h = self._res_stack(residual, mask, f"autoencoder.quantizer.predictor.{i}.enc", qcfg["prior_config"])
                residual = residual + h
            dist, _ = self.distances(emb, i)
            q = self.lookup(torch.argmin(dist, dim=-1), i)
            p = f"autoencoder.quantizer.postprocessor.{i}"
            post_in = q if residual is None else torch.cat([residual, q], dim=-1)
            h = self._lin(torch.tanh(self._lin(post_in, p + ".0")), p + ".2")
            residual = h if residual is None else residual + h
            if scales[i] > 1:
                residual = torch.repeat_interleave(residual, scales[i], dim=1)
        fd = self.acfg.get("frame_decoder_config")
        if fd is not None:
            residual, _ = self.fft_blocks(residual, positions(lengths[-1], residual.shape[1]),
                                          "autoencoder.frame_decoder", fd)
        return residual

    def decoder(self, feats):
        """HiFi-GAN: [B, F, C] -> waveform [B, F * prod(upsample_rates)]."""
        cfg = self.acfg["decoder_config"]
        p = "autoencoder.decoder"
        kernels, dilations = cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]
        x = self._wnconv(feats.transpose(1, 2), p + ".conv_pre", 3)
        for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
            w = weight_norm(self._w(f"{p}.ups.{i}.weight_v"), self._w(f"{p}.ups.{i}.weight_g"))
            x = self.ops.conv_transpose1d(F.leaky_relu(x, HIFIGAN_SLOPE), w, self._w(f"{p}.ups.{i}.bias"),
                                          u, (k - u) // 2)
            acc = None
            for j, (rk, rd) in enumerate(zip(kernels, dilations)):
                q = f"{p}.resblocks.{i * len(kernels) + j}"
                y = x
                for n, d in enumerate(rd):
                    h = self._wnconv(F.leaky_relu(y, HIFIGAN_SLOPE), f"{q}.convs1.{n}", (rk - 1) // 2 * d, d)
                    y = y + self._wnconv(F.leaky_relu(h, HIFIGAN_SLOPE), f"{q}.convs2.{n}", (rk - 1) // 2)
                acc = y if acc is None else acc + y
            x = acc / len(kernels)
        x = self._wnconv(F.leaky_relu(x, POST_SLOPE), p + ".conv_post", 3)
        return torch.tanh(x)[:, 0]

    # ---------------------------------------------------------------- all
    @torch.no_grad()
    def forward(self, text, text_length, frames: int, cap: int, served_dur=None, served_idx=None):
        """One block of requests at one frame bucket ``frames``.

        text [B, L, S], text_length [B]; ``served_dur`` [B, L] the run's
        rounded durations and ``served_idx`` its per-stage codeword indices
        (coarsest first, [B, T_i, H]), or None for the reference's own.
        Returns the duration head's output, the per-stage judgments, the
        frame totals (capped at ``cap``) and the waveform of each request
        trimmed to its own length."""
        x, non_pad = self.encode_text(text, text_length)
        dur = self.durations(x, non_pad)
        mask = (torch.arange(text.shape[1], device=text.device)[None, :] < text_length[:, None]).float()
        own = torch.round(torch.clamp(dur, min=0.0)) * mask
        expand = own if served_dur is None else served_dur.float() * mask
        # the phase-2 encoder pass runs on the same text: the same output
        regulated, total = self.regulate(x, expand, frames)
        stages, lengths = self.cascade(regulated, total, frames, served_idx)
        feats = self.synthesis_features([s["quant"] for s in stages], lengths)
        wav = self.decoder(feats)
        ratio = wav.shape[1] // frames
        capped = torch.clamp(total, max=min(cap, frames))
        return {
            "dur": dur, "stages": stages, "total": capped,
            "wav": [w[: int(n) * ratio] for w, n in zip(wav, capped)],
        }


def decoder_ratio(task: dict) -> int:
    return int(np.prod(task["autoencoder"]["decoder_config"]["upsample_rates"]))
