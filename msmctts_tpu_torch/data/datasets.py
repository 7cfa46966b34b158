"""Shape buckets and WAV output (the part of ``msmctts_tpu/data/datasets.py``
that inference needs).

Every batch is padded up to a bucket boundary from a fixed ladder, so the
set of distinct shapes the device sees stays small. Every frame bucket is a
multiple of 64, so any downsample/pred scale dividing 64 keeps shapes exact.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

FRAME_BUCKETS = (64, 128, 192, 256, 384, 512, 768, 1024, 1280, 1536, 2048, 2432)
TEXT_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256)


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    # round up to the bucket granularity past the ladder
    step = buckets[0]
    return ((n + step - 1) // step) * step


def save_wav(path: str, wav: np.ndarray, sample_rate: int):
    """float waveform in [-1, 1] -> 16-bit PCM WAV."""
    from scipy.io import wavfile

    wav = np.asarray(wav, np.float32).squeeze()
    wav = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sample_rate, (wav * 32767.0).astype(np.int16))
