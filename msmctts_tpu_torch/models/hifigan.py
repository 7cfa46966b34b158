"""HiFi-GAN generator and UnivNet discriminators (counterpart of
``msmctts_tpu/models/hifigan.py``).

Generator, ``eval()`` mode: every ResBlock1 dilation layer runs through
``ops/resblock.py`` (row 5 of the kernel table, on the card): 4 stages x 3
blocks x 3 dilations = 36 launches per CSMSC decode, 18 for the ISTFT
recipe's two-stage trunk. ``train()`` mode: the same layers
run as weight-normalised ``F.conv1d`` under autograd, as the JAX package's
training graph runs them as XLA convs (its fused kernel has no gradient and
is reached at inference only). The upsampling transposed convs and the
pre/post convs are plain PyTorch convs in both modes. Names follow the
reference (``conv_pre``, ``ups.i``, ``resblocks.r.convs1.m``, ``conv_post``).
The decoder family (``decoder_config._name``): ``HifiGANGenerator`` (tanh
head), ``ISTFTGenerator`` (the same trunk with a spectral head and
``ops/stft.istft_real_imag``) and ``MSGenerator`` (a speaker embedding
concatenated to the input of a ``HifiGANGenerator``).

Discriminators (``hifigan.py:194-348``): MultiResolutionDiscriminator (per
hop length an STFT image, 'double' domain, HTK mel warp, seven 3x3 conv2d
stages with reflection padding), MultiPeriodDiscriminator (waveform folded
by period, five strided (k, 1) conv2d stages and a post conv) and their
sum, UnivNetDiscriminator. They take [B, T] or [B, T, 1] and return
(scores, feature maps), the maps in torch's [B, C, H, W] layout (the JAX
package's are [B, H, W, C]). LeakyReLU slope 0.2.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from msmctts_tpu_torch.ops.convs import WNConv1d, WNConv2d, WNConvTranspose1d, fold_weight_norm
from msmctts_tpu_torch.ops.resblock import LRELU_SLOPE, fused_resblock_layer, prepare_taps
from msmctts_tpu_torch.ops.stft import istft_real_imag, mel_filterbank_htk, stft_real_imag
from msmctts_tpu_torch.parallel.sharding import copy_to_model, reduce_from_model
from msmctts_tpu_torch.registry import register_network

DISC_LRELU = 0.2


class _LeakyReLU(torch.autograd.Function):
    """``F.leaky_relu`` forward; the backward of ``jax.nn.leaky_relu``."""

    @staticmethod
    def forward(ctx, x, slope):
        ctx.save_for_backward(x)
        ctx.slope = slope
        return F.leaky_relu(x, slope)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, grad, grad * ctx.slope), None


def leaky_relu(x, slope: float):
    """``jax.nn.leaky_relu``: slope 1 at exactly 0 in the backward, where
    ``F.leaky_relu``'s backward takes ``slope``. The two differ wherever an
    activation is exactly 0, as a discriminator's zero-bias convs give over
    the zero-padded tail of a target window; the values are the same."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _LeakyReLU.apply(x, slope)
    return F.leaky_relu(x, slope)


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def receptive_field_frames(decoder_config) -> int:
    """Conservative one-sided receptive-field radius of HifiGANGenerator,
    in input-frame units (``msmctts_tpu/models/hifigan.py:40-70``, the same
    integer arithmetic).

    Any output sample depends only on input frames within this radius, so a
    chunk decoded with this much context on each side reproduces the
    monolithic decode in its interior (``streaming.py``). Every conversion
    rounds up.
    """
    rates = list(decoder_config["upsample_rates"])
    ks = list(decoder_config["upsample_kernel_sizes"])
    rks = list(decoder_config["resblock_kernel_sizes"])
    rds = list(decoder_config["resblock_dilation_sizes"])
    # MRF radius in stage-output units: within ResBlock1 each dilation d
    # applies conv(k, d) then conv(k, 1) sequentially (radii add through
    # the residual chain); parallel kernels take the max.
    mrf = max(
        sum((k - 1) * d // 2 + (k - 1) // 2 for d in dil)
        for k, dil in zip(rks, rds)
    )
    r = 3.0  # conv_pre, k=7
    cum = 1.0
    for u, k in zip(rates, ks):
        r += math.ceil(k / u) / cum  # transposed-conv input window
        cum *= u
        r += mrf / cum
    r += 3.0 / cum  # conv_post, k=7 (output-sample units)
    return int(math.ceil(r)) + 1  # slack for window-floor effects


class ResBlock1(nn.Module):
    """MRF residual block (hifigan/common.py:21-58). ``forward`` takes
    [B, T, C] and runs each dilation layer as one ``fused_resblock_layer``
    call on folded weights kept tap-major [k, C_in, C_out] and, beside them,
    split and laid out as the kernel streams them (``prepared_i``, from
    ``prepare_taps``); both are refreshed after every load and on every
    switch to eval.
    ``forward_ncl`` takes [B, C, T] and runs the same layers as two live
    weight-normalised convs each, for the training graph; under tensor
    parallelism (``parallel/sharding.py``) each pair holds its rank's
    channels, ``conv1_i`` column-parallel and ``conv2_i`` row-parallel, with
    one all-reduce per pair. A split block refuses ``eval()``: the fused
    kernel folds gathered weights only."""

    tp = None  # the model group while its pairs are split

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, _get_padding(kernel_size, d), d, hifigan_init=True)
            for d in self.dilations
        )
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, _get_padding(kernel_size, 1), hifigan_init=True)
            for _ in self.dilations
        )
        for i in range(len(self.dilations)):
            self.register_buffer(f"taps1_{i}", None, persistent=False)
            self.register_buffer(f"taps2_{i}", None, persistent=False)
            self.register_buffer(f"prepared_{i}", None, persistent=False)
        self.register_load_state_dict_post_hook(lambda module, _keys: module.fold())
        self.fold()

    @torch.no_grad()
    def fold(self):
        for i, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            taps1 = fold_weight_norm(c1.weight_v, c1.weight_g).permute(2, 1, 0).contiguous()
            taps2 = fold_weight_norm(c2.weight_v, c2.weight_g).permute(2, 1, 0).contiguous()
            setattr(self, f"taps1_{i}", taps1)
            setattr(self, f"taps2_{i}", taps2)
            setattr(self, f"prepared_{i}", prepare_taps(taps1, taps2) if taps1.shape[1] % 8 == 0 else None)

    def train(self, mode: bool = True):
        if not mode and self.tp is not None:
            raise RuntimeError("eval() of an MRF block split over a model group: gather its weights first")
        super().train(mode)
        if not mode:
            self.fold()
        return self

    def tp_layout(self, n_model: int):
        roles = {}
        for i in range(len(self.dilations)):
            roles.update({f"convs1.{i}.weight_v": 0, f"convs1.{i}.weight_g": 0, f"convs1.{i}.bias": 0,
                          f"convs2.{i}.weight_v": 1})
        return roles, None

    def set_model_group(self, group):
        self.tp = group
        for c2 in self.convs2:
            c2.norm_group = group

    def forward_ncl(self, x):
        tp = self.tp
        for c1, c2 in zip(self.convs1, self.convs2):
            h = leaky_relu(c1(copy_to_model(leaky_relu(x, LRELU_SLOPE), tp)), LRELU_SLOPE)
            if tp is None:
                x = x + c2(h)
            else:
                y = F.conv1d(h, c2.kernel().to(h.dtype), None, padding=c2.padding, dilation=c2.dilation)
                x = x + (reduce_from_model(y, tp) + c2.bias.to(y.dtype)[:, None])
        return x

    def forward(self, x):
        # the kernel reads and writes fp32 whatever the activations' dtype,
        # and its taps are folded in fp32 from the (possibly bf16) pairs
        # (msmctts_tpu/ops/pallas_resblock.py:129,153-158)
        for i, d in enumerate(self.dilations):
            x = fused_resblock_layer(
                x.float(), getattr(self, f"taps1_{i}"), self.convs1[i].bias.float(),
                getattr(self, f"taps2_{i}"), self.convs2[i].bias.float(), d, getattr(self, f"prepared_{i}"),
            ).to(x.dtype)
        return x


class ResBlock2(nn.Module):
    """Single-conv residual block (hifigan/common.py) over [B, T, C], in
    plain PyTorch; no CSMSC recipe uses it."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, _get_padding(kernel_size, d), d, hifigan_init=True)
            for d in dilations
        )

    def forward(self, x):
        x = x.transpose(1, 2)
        for conv in self.convs:
            x = x + conv(leaky_relu(x, LRELU_SLOPE))
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
        *,
        post_channels: int = 1,
    ):
        """``post_channels``: ``conv_post``'s outputs, which ``_head`` reads
        (1 here, the spectral bins of ``ISTFTGenerator``)."""
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        c0 = upsample_initial_channel
        self.conv_pre = WNConv1d(num_mels, c0, 7, padding=3)
        ups, blocks = [], []
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            ups.append(WNConvTranspose1d(c0 // (2**i), ch, k, u, (k - u) // 2, hifigan_init=True))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                blocks.append(ResBlock1(ch, rk, tuple(rd)))
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(blocks)
        self.conv_post = WNConv1d(c0 // (2 ** len(ups)), post_channels, 7, padding=3, hifigan_init=True)

    def _trunk_train(self, x):
        """The differentiable graph up to ``conv_post``'s output [B, C, T'],
        no kernel."""
        x = self.conv_pre(x.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x, LRELU_SLOPE))
            acc = None
            for j in range(self.num_kernels):
                r = self.resblocks[i * self.num_kernels + j].forward_ncl(x)
                acc = r if acc is None else acc + r
            x = acc / self.num_kernels
        return self.conv_post(leaky_relu(x, 0.01))

    def _trunk_eval(self, x):
        """The inference graph up to ``conv_post``'s output [B, C, T'], every
        MRF layer through the fused kernel."""
        x = self.conv_pre(x.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x, LRELU_SLOPE)).transpose(1, 2).contiguous()  # [B, T, C]
            acc = None
            for j in range(self.num_kernels):
                r = self.resblocks[i * self.num_kernels + j](x)
                acc = r if acc is None else acc + r
            x = (acc / self.num_kernels).transpose(1, 2)
        # the reference's final activation uses torch's DEFAULT slope 0.01
        # (generator.py:52), not the resblock slope
        return self.conv_post(leaky_relu(x, 0.01))

    def _head(self, y):
        """``conv_post``'s output [B, 1, T'] -> waveform [B, T', 1]."""
        return torch.tanh(y).transpose(1, 2)

    def forward(self, x):
        return self._head(self._trunk_train(x) if self.training else self._trunk_eval(x))


@register_network("ISTFTGenerator")
class ISTFTGenerator(HifiGANGenerator):
    """HiFi-GAN trunk with an inverse-STFT head
    (``msmctts_tpu/models/hifigan.py:351-419``): ``conv_post`` projects to
    2 * (n_fft // 2 + 1) channels, read as log-magnitude (clipped to
    [-11.5, 4]) and phase per bin, and ``ops/stft.istft_real_imag``
    (``center=False``) turns the frames into samples at hop ``istft_hop``;
    (n_fft - hop) // 2 samples of lead are trimmed and F * hop kept. There is
    no tanh. The trunk's names and modes are ``HifiGANGenerator``'s: in
    ``eval()`` every ResBlock1 layer runs through the fused kernel, in
    ``train()`` as live weight-normalised convs under autograd.
    [B, T, num_mels] -> [B, T * prod(upsample_rates) * istft_hop, 1]."""

    def __init__(
        self,
        resblock_kernel_sizes: Sequence[int],
        resblock_dilation_sizes: Sequence[Sequence[int]],
        upsample_rates: Sequence[int],
        upsample_initial_channel: int,
        upsample_kernel_sizes: Sequence[int],
        istft_hop: int = 10,
        istft_n_fft: int = 40,
        num_mels: int = 80,
    ):
        n_bins = int(istft_n_fft) // 2 + 1
        super().__init__(resblock_kernel_sizes, resblock_dilation_sizes, upsample_rates,
                         upsample_initial_channel, upsample_kernel_sizes, num_mels, post_channels=2 * n_bins)
        self.istft_hop = int(istft_hop)
        self.istft_n_fft = int(istft_n_fft)
        self.n_bins = n_bins

    def _head(self, spec):
        """[B, 2 * bins, F] -> waveform [B, F * hop, 1]."""
        logmag, phase = spec[:, : self.n_bins], spec[:, self.n_bins:]
        mag = torch.exp(torch.clamp(logmag, -11.5, 4.0))  # bounded away from inf
        n_fft, hop = self.istft_n_fft, self.istft_hop
        wav = istft_real_imag(mag * torch.cos(phase), mag * torch.sin(phase), n_fft, hop, n_fft, center=False)
        lead = (n_fft - hop) // 2
        return wav[:, lead: lead + spec.shape[-1] * hop, None]


@register_network("MSGenerator")
class MSGenerator(nn.Module):
    """Speaker-conditioned HiFi-GAN (``msmctts_tpu/models/hifigan.py:160-191``):
    ``spk`` [B, spk_dim] is broadcast over time and concatenated to the input
    of an inner ``HifiGANGenerator`` named ``generator``
    (``num_mels + spk_dim`` inputs). x [B, T, num_mels] -> [B, T * prod(rates), 1]."""

    def __init__(
        self,
        resblock_kernel_sizes: Sequence[int],
        resblock_dilation_sizes: Sequence[Sequence[int]],
        upsample_rates: Sequence[int],
        upsample_initial_channel: int,
        upsample_kernel_sizes: Sequence[int],
        num_mels: int = 80,
        spk_dim: int = 256,
    ):
        super().__init__()
        self.generator = HifiGANGenerator(resblock_kernel_sizes, resblock_dilation_sizes, upsample_rates,
                                          upsample_initial_channel, upsample_kernel_sizes, num_mels + spk_dim)

    def forward(self, x, spk):
        spk_t = spk[:, None, :].expand(x.shape[0], x.shape[1], spk.shape[-1]).to(x.dtype)
        return self.generator(torch.cat([x, spk_t], dim=-1))


def generator_upsample_ratio(decoder_config) -> int:
    """Samples per input frame for a decoder_config, decoder-family aware
    (``msmctts_tpu/models/hifigan.py:422-430``): prod(upsample_rates), times
    ``istft_hop`` for the ISTFTGenerator head."""
    ratio = math.prod(int(u) for u in decoder_config["upsample_rates"])
    if decoder_config.get("_name") == "ISTFTGenerator" or "istft_hop" in decoder_config:
        ratio *= int(decoder_config.get("istft_hop", 10))
    return ratio


class ReflectPad2d(nn.Module):
    """Reflection padding of 1 on both spatial dims of [B, C, H, W]. A dim of
    size 1 repeats its only value, as ``jnp.pad(mode='reflect')`` does
    (``torch``'s reflection padding refuses that case)."""

    def forward(self, x):
        x = F.pad(x, (1, 1, 0, 0), mode="reflect" if x.shape[3] > 1 else "replicate")
        return F.pad(x, (0, 0, 1, 1), mode="reflect" if x.shape[2] > 1 else "replicate")


class DiscriminatorR(nn.Module):
    """7-stage 3x3 conv2d spectrogram discriminator with reflection padding
    (``hifigan.py:194-224``). Input [B, C, F, T]; returns (score, fmaps). The
    feature maps are post-activation and leave out the last conv, as the
    reference's in-place LeakyReLU makes them. Each conv sits in an
    ``nn.Sequential`` at the reference's index (1 for stage 0, else 2)."""

    def __init__(self, hidden_channels: int = 512, in_channels: int = 2):
        super().__init__()
        hc = hidden_channels
        plan = [(hc // 32, 1), (hc // 16, 2), (hc // 8, 1), (hc // 4, 2), (hc // 2, 1), (hc, 2), (1, 1)]
        stages, c_in = [], in_channels
        for i, (feat, stride) in enumerate(plan):
            layers = [] if i == 0 else [nn.LeakyReLU(DISC_LRELU)]
            layers += [ReflectPad2d(), WNConv2d(c_in, feat, (3, 3), stride=stride)]
            stages.append(nn.Sequential(*layers))
            c_in = feat
        self.discriminator = nn.ModuleList(stages)

    def forward(self, x):
        fmaps = []
        for i, stage in enumerate(self.discriminator):
            if i > 0:
                x = leaky_relu(x, DISC_LRELU)
                fmaps.append(x)
            x = stage[-1](stage[-2](x))  # reflection pad, conv
        return x, fmaps


class MultiResolutionDiscriminator(nn.Module):
    """``hop_lengths``/``hidden_channels`` (fft = 4 * hop) or ``resolutions``
    [[n_fft, hop, win], ...] with a shared ``channels``
    (``hifigan.py:227-281``)."""

    def __init__(
        self,
        hop_lengths: Sequence[int] = (15, 30, 50, 120, 240, 480),
        hidden_channels: Sequence[int] = (128, 128, 256, 256, 512, 512),
        resolutions: Optional[Sequence[Sequence[int]]] = None,
        channels: Optional[int] = None,
        domain: str = "double",
        mel_scale: bool = True,
        sample_rate: int = 24000,
        ref_level_db: float = 20.0,
        min_level_db: float = -100.0,
    ):
        super().__init__()
        if resolutions is not None:
            self.plans = [(n_fft, hop, win, channels or 512) for (n_fft, hop, win) in resolutions]
        else:
            self.plans = [(hop * 4, hop, hop * 4, hc) for hop, hc in zip(hop_lengths, hidden_channels)]
        self.domain = domain
        self.mel_scale = mel_scale
        self.sample_rate = sample_rate
        self.ref_level_db = ref_level_db
        self.min_level_db = min_level_db
        self.discriminators = nn.ModuleList(
            DiscriminatorR(hc, 2 if domain == "double" else 1) for (_, _, _, hc) in self.plans
        )
        if mel_scale:
            for i, (n_fft, _, _, _) in enumerate(self.plans):
                n_bins = n_fft // 2 + 1
                fb = mel_filterbank_htk(n_bins, 0.0, sample_rate / 2, n_bins, sample_rate)
                self.register_buffer(f"mel_fb_{i}", torch.from_numpy(fb), persistent=False)

    def forward(self, wav):
        """wav [B, T] -> (scores list, fmaps list-of-lists)."""
        scores, fmaps = [], []
        for i, ((n_fft, hop, win, _), disc) in enumerate(zip(self.plans, self.discriminators)):
            real, imag = stft_real_imag(wav, n_fft, hop, win, center=True, normalized=True)
            mag = torch.sqrt(torch.clamp(real * real + imag * imag, min=1e-7))
            if self.mel_scale:
                mag = torch.einsum("bft,fm->bmt", mag, getattr(self, f"mel_fb_{i}"))
            if self.domain == "double":
                log_mag = 20.0 * torch.log10(mag) - self.ref_level_db
                log_mag = torch.clamp((log_mag - self.min_level_db) / -self.min_level_db, 0.0, 1.0)
                img = torch.stack([mag, log_mag], dim=1)  # [B, 2, F, T']
            else:
                img = mag[:, None]
            score, fmap = disc(img)
            scores.append(score)
            fmaps.append(fmap)
        return scores, fmaps


class DiscriminatorP(nn.Module):
    """Period discriminator (``hifigan.py:284-316``); input [B, T]. The
    feature maps are pre-activation."""

    def __init__(self, period: int, channels: int = 32, max_channels: int = 1024,
                 kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        ch = channels
        chans = [ch, ch * 4, min(max_channels, ch * 16), min(max_channels, ch * 32)]
        pad = _get_padding(kernel_size, 1)
        convs, c_in = [], 1
        for c in chans:
            convs.append(WNConv2d(c_in, c, (kernel_size, 1), stride=(stride, 1), padding=(pad, 0)))
            c_in = c
        convs.append(WNConv2d(c_in, c_in, (5, 1), stride=(1, 1), padding=(2, 0)))
        self.convs = nn.ModuleList(convs)
        self.conv_post = WNConv2d(c_in, 1, (3, 1), padding=(1, 0))

    def forward(self, wav):
        B, T = wav.shape
        p = self.period
        if T % p != 0:
            n_pad = p - (T % p)
            wav = F.pad(wav[:, None], (0, n_pad), mode="reflect")[:, 0]
            T = T + n_pad
        x = wav.reshape(B, 1, T // p, p)
        fmaps = []
        for conv in self.convs:
            x = conv(x)
            fmaps.append(x)
            x = leaky_relu(x, DISC_LRELU)
        return self.conv_post(x).reshape(B, -1), fmaps


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), channels: int = 32, max_channels: int = 1024):
        super().__init__()
        self.periods = tuple(periods)
        self.discriminators = nn.ModuleList(DiscriminatorP(p, channels, max_channels) for p in self.periods)

    def forward(self, wav):
        scores, fmaps = [], []
        for disc in self.discriminators:
            s, f = disc(wav)
            scores.append(s)
            fmaps.append(f)
        return scores, fmaps


@register_network("UnivNetDiscriminator")
class UnivNetDiscriminator(nn.Module):
    """MRD + MPD (``hifigan.py:334-348``). Input [B, T] or [B, T, 1];
    returns the concatenated (scores, fmaps)."""

    def __init__(self, mrd_config: dict, mpd_config: dict):
        super().__init__()
        self.mrd = MultiResolutionDiscriminator(**dict(mrd_config))
        self.mpd = MultiPeriodDiscriminator(**dict(mpd_config))

    def forward(self, wav):
        if wav.dim() == 3:
            wav = wav[..., 0]
        mrd_s, mrd_f = self.mrd(wav)
        mpd_s, mpd_f = self.mpd(wav)
        return mrd_s + mpd_s, mrd_f + mpd_f
