"""Training criterions as pure functions (counterpart of
``msmctts_tpu/training/losses.py:25-170``).

  * quantizer loss: masked, length- and dim-normalized VQ commitment terms
    plus the prior-prediction loss dict;
  * frame loss (masked mel MSE) and duration loss;
  * mel loss: HiFi-GAN log-mel L1; (multi-resolution) STFT loss: spectral
    convergence + log-magnitude L1;
  * LSGAN adversarial and feature-matching terms.

Everything is float32. The discriminator is applied to the fake and the real
batch in two separate calls, never to one concatenated batch: the reference
evaluates it that way, and the JAX package keeps it so.
"""

from __future__ import annotations

from typing import Sequence

import torch

from msmctts_tpu_torch.ops.masking import sequence_mask
from msmctts_tpu_torch.ops.stft import _constant, mel_spectrogram_hifigan, stft_magnitude


def masked_diff_loss(term, lengths):
    """sum over valid frames / sum(lengths) / feature_dim."""
    term = term.float()
    mask = sequence_mask(lengths, term.shape[1], dtype=torch.float32)[..., None]
    denom = torch.clamp(lengths.float().sum(), min=1.0)
    return torch.sum(term * mask) / denom / term.shape[2]


def quantizer_loss(encoder_diffs, encoder_lengths, decoder_diffs, lambda_vq=1.0, lambda_pr=1.0):
    """Returns (vq_loss scalar, metrics dict)."""
    metrics = {}
    vq = torch.zeros((), dtype=torch.float32, device=encoder_diffs[0].device)
    for i, (diff, length) in enumerate(zip(encoder_diffs, encoder_lengths)):
        term = masked_diff_loss(diff, length)
        metrics[f"latent_loss_{i}_0"] = term
        vq = vq + lambda_vq * term
    if decoder_diffs is not None:
        vq = vq + lambda_pr * decoder_diffs["total_loss"]
        for k, v in decoder_diffs.items():
            if k != "total_loss":
                metrics[k] = v
    metrics["vq_loss"] = vq
    return vq, metrics


def frame_loss(pred_mel, target_mel, lengths):
    """Masked mel-reconstruction MSE."""
    return masked_diff_loss(torch.square(pred_mel.float() - target_mel.float()), lengths)


def duration_loss(dur_pred, dur_target, text_lengths):
    """Masked duration MSE normalized by total text length."""
    sq = torch.square(dur_pred.float() - dur_target.float())
    mask = sequence_mask(text_lengths, sq.shape[1], dtype=torch.float32)
    denom = torch.clamp(text_lengths.float().sum(), min=1.0)
    return torch.sum(sq * mask) / denom


def mel_loss(pred_wav, target_wav, sample_rate, fft_size=None, hop_size=None, win_size=None, num_mels=128):
    """HiFi-GAN-style log-mel L1; defaults derived from the sample rate."""
    win_size = win_size or sample_rate // 20
    hop_size = hop_size or sample_rate // 80
    fft_size = fft_size or (2048 if win_size > 1024 else 1024)
    p = mel_spectrogram_hifigan(pred_wav, sample_rate, fft_size, hop_size, win_size, num_mels)
    t = mel_spectrogram_hifigan(target_wav, sample_rate, fft_size, hop_size, win_size, num_mels)
    return torch.mean(torch.abs(p - t))


def _sc_and_mag(p, t):
    sc = torch.linalg.norm(t - p) / torch.clamp(torch.linalg.norm(t), min=1e-8)
    logp = torch.log(torch.clamp(p, 1e-5, 10.0))
    logt = torch.log(torch.clamp(t, 1e-5, 10.0))
    return sc, torch.mean(torch.abs(logp - logt))


def stft_loss(pred_wav, target_wav, fft_size: int = 1024, win_size: int = 600, hop_size: int = 120,
              mel_scale: bool = False, sample_rate: int = 24000, num_mels: int = 80):
    """Single-resolution STFT loss: spectral convergence + log-magnitude
    L1, with an optional mel warp. Returns {sc_loss, mag_loss}."""
    p = stft_magnitude(pred_wav, fft_size, hop_size, win_size)
    t = stft_magnitude(target_wav, fft_size, hop_size, win_size)
    if mel_scale:
        fb = _constant("mel", (sample_rate, fft_size, num_mels), str(p.device))
        p = torch.einsum("mf,bft->bmt", fb, p)
        t = torch.einsum("mf,bft->bmt", fb, t)
    sc, mag = _sc_and_mag(p, t)
    return {"sc_loss": sc, "mag_loss": mag}


def multi_resolution_stft_loss(pred_wav, target_wav, fft_sizes: Sequence[int] = (1024, 2048, 512),
                               win_sizes: Sequence[int] = (600, 1200, 300),
                               hop_sizes: Sequence[int] = (120, 240, 60)):
    """Returns dict {sc_loss, mag_loss} averaged over resolutions."""
    sc, mag = [], []
    for n_fft, win, hop in zip(fft_sizes, win_sizes, hop_sizes):
        s, m = _sc_and_mag(stft_magnitude(pred_wav, n_fft, hop, win), stft_magnitude(target_wav, n_fft, hop, win))
        sc.append(s)
        mag.append(m)
    n = len(sc)
    return {"sc_loss": sum(sc) / n, "mag_loss": sum(mag) / n}


def paired_disc_apply(disc, fake, real):
    """Apply a discriminator to the (fake, real) pair, as two separate calls.
    Returns ``(fake_scores, fake_fmaps, real_scores, real_fmaps)``."""
    fs, ff = disc(fake)
    rs, rf = disc(real)
    return fs, ff, rs, rf


def lsgan_d_loss(real_scores, fake_scores):
    """Sum over discriminators of MSE-to-1 (real) and MSE-to-0 (fake)."""
    real = sum(torch.mean(torch.square(s.float() - 1.0)) for s in real_scores)
    fake = sum(torch.mean(torch.square(s.float())) for s in fake_scores)
    return real, fake


def lsgan_g_loss(fake_scores):
    return sum(torch.mean(torch.square(s.float() - 1.0)) for s in fake_scores)


def feature_matching_loss(fake_feats, real_feats):
    total = 0.0
    for ff, rf in zip(fake_feats, real_feats):
        for f, r in zip(ff, rf):
            total = total + torch.mean(torch.abs(f.float() - r.float()))
    return total
