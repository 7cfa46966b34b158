"""Host-side audio DSP in numpy (counterpart of ``msmctts_tpu/utils/audio.py``).

The CSMSC / LJSpeech mel pipeline of the reference recipes without librosa:
pre-emphasis, a centre-padded reflect STFT, the Slaney mel filterbank,
20 * log10 amplitude-to-dB with a 1e-5 floor, ref-level subtraction and
symmetric [-max_abs, max_abs] normalization; the mel-cepstral distance the
AS-MCD sweep scores with (``tools/as_mcd_sweep.py``); Griffin-Lim; mu-law
companding; biquad filters; a sine excitation from log-F0. The window and
the filterbank are the port's own (``ops/stft.py``). Everything here runs
on the host, on numpy arrays, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import signal as sps

from msmctts_tpu_torch.ops.stft import hann_window, mel_filterbank


@dataclass
class AudioConfig:
    num_mels: int = 80
    num_freq: int = 1025
    sample_rate: int = 24000
    frame_length_ms: float = 50.0
    frame_shift_ms: float = 12.5
    preemphasis: float = 0.97
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    max_abs_value: float = 4.0
    symmetric_specs: bool = True

    @property
    def n_fft(self) -> int:
        return (self.num_freq - 1) * 2

    @property
    def hop_length(self) -> int:
        return int(self.frame_shift_ms / 1000 * self.sample_rate)

    @property
    def win_length(self) -> int:
        return int(self.frame_length_ms / 1000 * self.sample_rate)


def preemphasis(x: np.ndarray, coef: float) -> np.ndarray:
    return sps.lfilter([1.0, -coef], [1.0], x)


def inv_preemphasis(x: np.ndarray, coef: float) -> np.ndarray:
    return sps.lfilter([1.0], [1.0, -coef], x)


def _padded_window(n_fft: int, win: int) -> np.ndarray:
    """The periodic Hann window of ``win`` samples centred in ``n_fft``."""
    window = hann_window(win)
    if win < n_fft:
        lpad = (n_fft - win) // 2
        window = np.pad(window, (lpad, n_fft - win - lpad))
    return window


def stft_np(y: np.ndarray, n_fft: int, hop: int, win: int) -> np.ndarray:
    """librosa-convention STFT: Hann window centre-padded to ``n_fft``,
    reflect-padded signal; complex [n_fft // 2 + 1, frames]."""
    window = _padded_window(n_fft, win)
    y = np.pad(y, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    frames = np.lib.stride_tricks.as_strided(y, shape=(n_frames, n_fft), strides=(y.strides[0] * hop, y.strides[0]))
    return np.fft.rfft(frames * window[None, :], axis=-1).T


def _amp_to_db(x):
    return 20.0 * np.log10(np.maximum(1e-5, x))


def _db_to_amp(x):
    return np.power(10.0, x * 0.05)


def _normalize(S, cfg: AudioConfig):
    span = (S - cfg.min_level_db) / -cfg.min_level_db
    if cfg.symmetric_specs:
        return np.clip(2 * cfg.max_abs_value * span - cfg.max_abs_value, -cfg.max_abs_value, cfg.max_abs_value)
    return np.clip(cfg.max_abs_value * span, 0, cfg.max_abs_value)


def denormalize(S, cfg: AudioConfig):
    if cfg.symmetric_specs:
        return ((np.clip(S, -cfg.max_abs_value, cfg.max_abs_value) + cfg.max_abs_value)
                * -cfg.min_level_db / (2 * cfg.max_abs_value) + cfg.min_level_db)
    return np.clip(S, 0, cfg.max_abs_value) * -cfg.min_level_db / cfg.max_abs_value + cfg.min_level_db


def melspectrogram(wav: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """wav [T] -> normalized mel [frames, num_mels], time-major."""
    D = stft_np(preemphasis(wav, cfg.preemphasis), cfg.n_fft, cfg.hop_length, cfg.win_length)
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels)
    S = _amp_to_db(fb @ np.abs(D)) - cfg.ref_level_db
    return _normalize(S, cfg).T.astype(np.float32)


def spectrogram(wav: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """wav [T] -> normalized linear spectrogram [frames, n_fft // 2 + 1]."""
    D = stft_np(preemphasis(wav, cfg.preemphasis), cfg.n_fft, cfg.hop_length, cfg.win_length)
    S = _amp_to_db(np.abs(D)) - cfg.ref_level_db
    return _normalize(S, cfg).T.astype(np.float32)


def griffin_lim(S: np.ndarray, cfg: AudioConfig, n_iters: int = 60, power: float = 1.5) -> np.ndarray:
    """Waveform from a normalized linear spectrogram [T, F] (``spectrogram``'s
    output) by Griffin-Lim, at the recipe's 60 iterations and power 1.5;
    the initial phases come from ``RandomState(0)``."""
    D = _db_to_amp(denormalize(S.T, cfg) + cfg.ref_level_db) ** power
    n_fft, hop, win = cfg.n_fft, cfg.hop_length, cfg.win_length
    angles = np.exp(2j * np.pi * np.random.RandomState(0).rand(*D.shape))
    y = _istft_np(D.astype(np.complex128) * angles, n_fft, hop, win)
    for _ in range(n_iters):
        angles = np.exp(1j * np.angle(stft_np(y, n_fft, hop, win)[:, : D.shape[1]]))
        if angles.shape != D.shape:
            angles = np.pad(angles, ((0, 0), (0, D.shape[1] - angles.shape[1])), mode="edge")
        y = _istft_np(D * angles, n_fft, hop, win)
    return inv_preemphasis(y, cfg.preemphasis).astype(np.float32)


def _istft_np(D: np.ndarray, n_fft: int, hop: int, win: int) -> np.ndarray:
    """Overlap-add inverse STFT with the window-sum-square correction."""
    window = _padded_window(n_fft, win)
    frames = np.fft.irfft(D.T, n=n_fft, axis=-1)  # [n_frames, n_fft]
    n_frames = frames.shape[0]
    T = n_fft + hop * (n_frames - 1)
    y = np.zeros(T)
    wsum = np.zeros(T)
    for i in range(n_frames):
        y[i * hop: i * hop + n_fft] += frames[i] * window
        wsum[i * hop: i * hop + n_fft] += window ** 2
    y[wsum > 1e-10] /= wsum[wsum > 1e-10]
    return y[n_fft // 2: -(n_fft // 2)] if T > n_fft else y


def mulaw_encode(x: np.ndarray, mu: int = 255) -> np.ndarray:
    """mu-law companding to integer codes in [0, mu]."""
    x = np.clip(x, -1.0, 1.0)
    fx = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    return ((fx + 1) / 2 * mu + 0.5).astype(np.int64)


def mulaw_decode(y: np.ndarray, mu: int = 255) -> np.ndarray:
    """Inverse of ``mulaw_encode``, to float32."""
    fx = 2 * y.astype(np.float64) / mu - 1
    return (np.sign(fx) / mu * ((1 + mu) ** np.abs(fx) - 1)).astype(np.float32)


def _biquad(cutoff_hz: float, sample_rate: int, q: float, sign: float):
    w0 = 2 * np.pi * cutoff_hz / sample_rate
    alpha = np.sin(w0) / (2 * q)
    cos_w0 = np.cos(w0)
    edge = (1 + sign * cos_w0) / 2
    b = np.array([edge, -sign * 2 * edge, edge])
    a = np.array([1 + alpha, -2 * cos_w0, 1 - alpha])
    return b / a[0], a / a[0]


def biquad_lowpass(cutoff_hz: float, sample_rate: int, q: float = 0.707):
    """Biquad low-pass coefficients (b, a), for ``scipy.signal.lfilter``."""
    return _biquad(cutoff_hz, sample_rate, q, -1.0)


def biquad_highpass(cutoff_hz: float, sample_rate: int, q: float = 0.707):
    """Biquad high-pass coefficients (b, a), for ``scipy.signal.lfilter``."""
    return _biquad(cutoff_hz, sample_rate, q, 1.0)


def lf0_to_sine(lf0: np.ndarray, frameshift: int, sample_rate: int, sine_amp: float = 0.1,
                noise_std: float = 0.003, voiced_threshold: float = 0.0, seed: int = 0) -> np.ndarray:
    """Frame-level log-F0 -> sample-level sine excitation, noise where
    unvoiced (frames with ``lf0 <= voiced_threshold``)."""
    f0 = np.where(lf0 > voiced_threshold, np.exp(lf0), 0.0)
    f0_samples = np.repeat(f0, frameshift)
    voiced = f0_samples > 0
    phase = 2 * np.pi * np.cumsum(f0_samples / sample_rate)
    sine = sine_amp * np.sin(phase) * voiced
    noise = np.random.RandomState(seed).randn(len(f0_samples)) * (noise_std * voiced + (sine_amp / 3.0) * (~voiced))
    return (sine + noise).astype(np.float32)


def mcd(mel_a: np.ndarray, mel_b: np.ndarray) -> float:
    """Mel-cepstral-distortion-style distance in dB between two [T, M]
    log-mel sequences, over their common frames."""
    n = min(len(mel_a), len(mel_b))
    diff = np.asarray(mel_a[:n], np.float64) - np.asarray(mel_b[:n], np.float64)
    return float(np.mean(np.sqrt(np.sum(diff ** 2, axis=-1))) * (10.0 / np.log(10.0)) * np.sqrt(2.0))
