"""STFT, its inverse and mel filterbanks (counterpart of
``msmctts_tpu/ops/stft.py:32-270``).

The STFT is a framed matrix product against a windowed DFT basis, as in the
JAX package (which runs it as a strided convolution): frames of ``n_fft``
samples every ``hop_length`` samples, times a [n_fft, 2 * bins] matrix of
windowed cos and -sin rows. It is differentiable, runs in full fp32, and
follows ``torch.stft``'s conventions: a periodic Hann window centre-padded
to ``n_fft``, reflect padding of ``n_fft // 2`` when ``center``, and
``normalized`` dividing by sqrt(n_fft).

The inverse (``istft_real_imag``) is one transposed convolution of the
[B, 2 * bins, frames] spectral frames with the windowed inverse-DFT basis at
stride ``hop_length``, divided by the window-square overlap-add normalizer,
as the JAX package computes it (an XLA ``conv_transpose`` outside any Pallas
kernel); here ``F.conv_transpose1d`` on both devices, in fp32.

Two mel filterbanks, both from their published formulas: the librosa-style
Slaney bank of the mel loss, and the torchaudio-style HTK matrix of the MRD
discriminator's mel warp.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window / fftbins=True)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _hz_to_mel(f, htk: bool):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney scale: linear below 1 kHz, log above.
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels
    )


def _mel_to_hz(m, htk: bool):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular filterbank (librosa convention)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]  # [n_mels+2, n_freqs]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[:, None]
    return fb.astype(np.float32)


def mel_filterbank_htk(n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: int) -> np.ndarray:
    """[n_freqs, n_mels] HTK-mel matrix (torchaudio ``create_fb_matrix``):
    linspace over 0..sr//2, clamp(1e-6, 1), no area normalization."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_min = 2595.0 * np.log10(1.0 + f_min / 700.0)
    m_max = 2595.0 * np.log10(1.0 + f_max / 700.0)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels+2]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.clip(np.minimum(down, up), 1e-6, 1.0)
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """[2*(n_fft//2+1), n_fft]: windowed cos rows, then -sin rows; the dot
    of a frame with row k is Re / Im of DFT bin k."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[None, :]
    k = np.arange(n_bins)[:, None]
    angle = 2.0 * np.pi * k * t / n_fft
    basis = np.concatenate([np.cos(angle), -np.sin(angle)], axis=0)
    return (basis * _padded_window(n_fft, win_length)[None, :]).astype(np.float32)


def _padded_window(n_fft: int, win_length: int) -> np.ndarray:
    """The Hann window centre-padded to ``n_fft`` (librosa / torch)."""
    window = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    return window


@functools.lru_cache(maxsize=None)
def _idft_kernels(n_fft: int, win_length: int) -> np.ndarray:
    """Synthesis kernels [2*(n_fft//2+1), 1, n_fft] inverting the analysis
    basis (``msmctts_tpu/ops/stft.py:193-215``): row k of the cos block is
    w_k / n_fft * cos(2 pi k t / n_fft) (w_k = 2 but for DC and Nyquist), the
    sin block the matching -sin, both times the window."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[None, :]
    k = np.arange(n_bins)[:, None]
    angle = 2.0 * np.pi * k * t / n_fft
    weights = np.full((n_bins, 1), 2.0)
    weights[0] = 1.0
    if n_fft % 2 == 0:
        weights[-1] = 1.0
    basis = np.concatenate([weights * np.cos(angle), -weights * np.sin(angle)], axis=0) / float(n_fft)
    return (basis * _padded_window(n_fft, win_length)[None, :]).astype(np.float32)[:, None, :]


def _window_square(n_fft: int, win_length: int) -> np.ndarray:
    """[1, 1, n_fft]: the squared window, the overlap-add normalizer's kernel."""
    window = _padded_window(n_fft, win_length)
    return (window * window).astype(np.float32)[None, None, :]


@functools.lru_cache(maxsize=None)
def _constant(kind: str, args: tuple, device: str) -> torch.Tensor:
    """A host-made constant (DFT bases, window, filterbank) as a tensor on
    ``device``; made outside inference mode, so that a constant first made by
    an inference call still serves a training graph."""
    make = {"dft": _dft_basis, "idft": _idft_kernels, "wsq": _window_square, "mel": mel_filterbank}[kind]
    with torch.inference_mode(False):
        return torch.from_numpy(make(*args)).to(device)


def stft_real_imag(x, n_fft: int, hop_length: int, win_length: int, center: bool = True,
                   normalized: bool = False):
    """Real/imag STFT of [B, T] -> each [B, n_fft//2+1, frames]."""
    basis = _constant("dft", (n_fft, win_length), str(x.device))  # [2*bins, n_fft]
    x = x.float()
    if center:
        x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop_length)  # [B, frames, n_fft]
    out = torch.matmul(frames, basis.t()).transpose(1, 2)  # [B, 2*bins, frames]
    n_bins = n_fft // 2 + 1
    real, imag = out[:, :n_bins], out[:, n_bins:]
    if normalized:
        scale = 1.0 / np.sqrt(n_fft)
        real, imag = real * scale, imag * scale
    return real, imag


def istft_real_imag(real, imag, n_fft: int, hop_length: int, win_length: int, center: bool = True,
                    eps: float = 1e-9):
    """Inverse of ``stft_real_imag`` (``msmctts_tpu/ops/stft.py:218-270``):
    [B, n_fft//2+1, frames] x 2 -> [B, T], least-squares overlap-add with
    window-square normalization; T = (frames - 1) * hop + n_fft, less
    ``n_fft // 2`` at each end when ``center``. Differentiable.

    A transposed convolution with a [in, out, k] weight is the gradient of
    the forward convolution with that weight, which is what the JAX
    package's ``conv_transpose(..., transpose_kernel=True)`` over an OIH
    kernel computes: the same [2 * bins, 1, n_fft] array serves both."""
    dev = str(real.device)
    frames = torch.cat([real, imag], dim=1).float()
    x = F.conv_transpose1d(frames, _constant("idft", (n_fft, win_length), dev), stride=hop_length)[:, 0]
    ones = torch.ones((1, 1, real.shape[-1]), dtype=torch.float32, device=real.device)
    norm = F.conv_transpose1d(ones, _constant("wsq", (n_fft, win_length), dev), stride=hop_length)[:, 0]
    x = x / torch.clamp(norm, min=eps)
    if center:
        half = n_fft // 2
        x = x[:, half: x.shape[1] - half]
    return x


def stft_magnitude(x, n_fft, hop_length, win_length, center=True, normalized=False, eps=1e-7):
    real, imag = stft_real_imag(x, n_fft, hop_length, win_length, center, normalized)
    return torch.sqrt(torch.clamp(real * real + imag * imag, min=eps))


def mel_spectrogram_hifigan(wav, sample_rate: int, n_fft: int, hop_length: int, win_length: int,
                            n_mels: int, eps: float = 1e-9, clip_val: float = 1e-5):
    """HiFi-GAN-style log-mel of the mel loss: reflect pad (n_fft-hop)/2 both
    sides, center=False STFT, Slaney mel, log(clamp(., 1e-5))."""
    pad = (n_fft - hop_length) // 2
    wav = F.pad(wav.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    real, imag = stft_real_imag(wav, n_fft, hop_length, win_length, center=False)
    mag = torch.sqrt(real * real + imag * imag + eps)
    fb = _constant("mel", (sample_rate, n_fft, n_mels), str(wav.device))
    mel = torch.einsum("mf,bft->bmt", fb, mag)
    return torch.log(torch.clamp(mel, min=clip_val))
