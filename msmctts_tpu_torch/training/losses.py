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

Under data parallelism (``group``, ``parallel/mesh.py``) every function
returns this rank's *share* of the global term: the shares of all ranks add
up to what one rank would compute on the whole batch, so summed gradients
are the global gradient. A masked term divides its local sum by the global
denominator (``lengths`` summed over ranks); a ``torch.mean`` over equal
shards is divided by the number of ranks; the spectral convergence, a ratio
of global norms, is formed on every rank from the summed squared norms and
shared out in equal parts. Without a group the shares are the terms.

A mean over the batch rows is ``sum(weights * term) / (n_windows * elements
per row)`` for ``windows=(weights, n_windows)``; by default every row weighs
1 among the ``b * world`` rows of equal shards. The QS-TTS trainer passes
its own: a rank's rows are some of the ``n_windows`` decoded windows of the
global batch, as many as it holds, and not the same number on every rank.
A rank that holds no window decodes one stand-in row with weight 0, so that
it runs the same operations and collectives as the others and adds nothing.
"""

from __future__ import annotations

from typing import Sequence

import torch

from msmctts_tpu_torch.ops.masking import sequence_mask
from msmctts_tpu_torch.parallel.mesh import all_reduce_sum, sum_over_ranks, world
from msmctts_tpu_torch.ops.stft import _constant, mel_spectrogram_hifigan, stft_magnitude


def _windows(term, group, windows):
    """``windows``, or those of equal shards: every one of the ``b`` rows of
    ``term`` [b, ...] weighs 1 among the ``b * world`` rows of all ranks."""
    if windows is None:
        return torch.ones(term.shape[0], device=term.device), term.shape[0] * world(group)
    return windows


def _row_weights(weights, term):
    """``weights`` [b] shaped to broadcast over ``term`` [b, ...]."""
    return weights.reshape(-1, *([1] * (term.dim() - 1)))


def _mean(term, group, windows):
    """This rank's share of the mean of ``term`` [b, ...] over the rows of
    every rank: ``sum(weights * term) / (n_windows * elements per row)``."""
    weights, n_windows = _windows(term, group, windows)
    term = term.float()
    return torch.sum(term * _row_weights(weights, term)) / (term[0].numel() * n_windows)


def global_length_sum(lengths, group=None):
    """sum(lengths) over the batch rows of every rank, at least 1: the
    denominator of the masked losses."""
    return torch.clamp(all_reduce_sum(lengths.float().sum(), group), min=1.0)


def masked_diff_loss(term, lengths, group=None):
    """sum over valid frames / sum(lengths) / feature_dim."""
    term = term.float()
    mask = sequence_mask(lengths, term.shape[1], dtype=torch.float32)[..., None]
    return torch.sum(term * mask) / global_length_sum(lengths, group) / term.shape[2]


def quantizer_loss(encoder_diffs, encoder_lengths, decoder_diffs, lambda_vq=1.0, lambda_pr=1.0, group=None):
    """Returns (vq_loss scalar, metrics dict)."""
    metrics = {}
    vq = torch.zeros((), dtype=torch.float32, device=encoder_diffs[0].device)
    for i, (diff, length) in enumerate(zip(encoder_diffs, encoder_lengths)):
        term = masked_diff_loss(diff, length, group)
        metrics[f"latent_loss_{i}_0"] = term
        vq = vq + lambda_vq * term
    if decoder_diffs is not None:
        vq = vq + lambda_pr * decoder_diffs["total_loss"]
        for k, v in decoder_diffs.items():
            if k != "total_loss":
                metrics[k] = v
    metrics["vq_loss"] = vq
    return vq, metrics


def frame_loss(pred_mel, target_mel, lengths, group=None):
    """Masked mel-reconstruction MSE."""
    return masked_diff_loss(torch.square(pred_mel.float() - target_mel.float()), lengths, group)


def duration_loss(dur_pred, dur_target, text_lengths, group=None):
    """Masked duration MSE normalized by total text length."""
    sq = torch.square(dur_pred.float() - dur_target.float())
    mask = sequence_mask(text_lengths, sq.shape[1], dtype=torch.float32)
    return torch.sum(sq * mask) / global_length_sum(text_lengths, group)


def mel_loss(pred_wav, target_wav, sample_rate, fft_size=None, hop_size=None, win_size=None, num_mels=128,
             group=None, windows=None):
    """HiFi-GAN-style log-mel L1; defaults derived from the sample rate."""
    win_size = win_size or sample_rate // 20
    hop_size = hop_size or sample_rate // 80
    fft_size = fft_size or (2048 if win_size > 1024 else 1024)
    p = mel_spectrogram_hifigan(pred_wav, sample_rate, fft_size, hop_size, win_size, num_mels)
    t = mel_spectrogram_hifigan(target_wav, sample_rate, fft_size, hop_size, win_size, num_mels)
    return _mean(torch.abs(p - t), group, windows)


def _sc_and_mag(p, t, group=None, windows=None):
    logp = torch.log(torch.clamp(p, 1e-5, 10.0))
    logt = torch.log(torch.clamp(t, 1e-5, 10.0))
    mag = _mean(torch.abs(logp - logt), group, windows)
    # |t - p| / |t| over every rank's weighted rows, from the summed squared norms
    w = _row_weights(_windows(t, group, windows)[0], t)
    sq = sum_over_ranks(torch.stack([torch.sum(w * torch.square(t - p)), torch.sum(w * torch.square(t))]), group)
    return torch.sqrt(sq[0]) / torch.clamp(torch.sqrt(sq[1]), min=1e-8) / world(group), mag


def stft_loss(pred_wav, target_wav, fft_size: int = 1024, win_size: int = 600, hop_size: int = 120,
              mel_scale: bool = False, sample_rate: int = 24000, num_mels: int = 80, group=None, windows=None):
    """Single-resolution STFT loss: spectral convergence + log-magnitude
    L1, with an optional mel warp. Returns {sc_loss, mag_loss}."""
    p = stft_magnitude(pred_wav, fft_size, hop_size, win_size)
    t = stft_magnitude(target_wav, fft_size, hop_size, win_size)
    if mel_scale:
        fb = _constant("mel", (sample_rate, fft_size, num_mels), str(p.device))
        p = torch.einsum("mf,bft->bmt", fb, p)
        t = torch.einsum("mf,bft->bmt", fb, t)
    sc, mag = _sc_and_mag(p, t, group, windows)
    return {"sc_loss": sc, "mag_loss": mag}


def multi_resolution_stft_loss(pred_wav, target_wav, fft_sizes: Sequence[int] = (1024, 2048, 512),
                               win_sizes: Sequence[int] = (600, 1200, 300),
                               hop_sizes: Sequence[int] = (120, 240, 60), group=None, windows=None):
    """Returns dict {sc_loss, mag_loss} averaged over resolutions."""
    sc, mag = [], []
    for n_fft, win, hop in zip(fft_sizes, win_sizes, hop_sizes):
        s, m = _sc_and_mag(stft_magnitude(pred_wav, n_fft, hop, win), stft_magnitude(target_wav, n_fft, hop, win),
                           group, windows)
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


def lsgan_d_loss(real_scores, fake_scores, group=None, windows=None):
    """Sum over discriminators of MSE-to-1 (real) and MSE-to-0 (fake)."""
    real = sum(_mean(torch.square(s.float() - 1.0), group, windows) for s in real_scores)
    fake = sum(_mean(torch.square(s.float()), group, windows) for s in fake_scores)
    return real, fake


def lsgan_g_loss(fake_scores, group=None, windows=None):
    return sum(_mean(torch.square(s.float() - 1.0), group, windows) for s in fake_scores)


def feature_matching_loss(fake_feats, real_feats, group=None, windows=None):
    total = 0.0
    for ff, rf in zip(fake_feats, real_feats):
        for f, r in zip(ff, rf):
            total = total + _mean(torch.abs(f.float() - r.float()), group, windows)
    return total
