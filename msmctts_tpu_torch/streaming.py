"""Streaming (chunked) HiFi-GAN decode for low time-to-first-audio (the
counterpart of ``msmctts_tpu/streaming.py:39-173``).

The generator is a finite-receptive-field convolutional stack, so an output
sample depends only on input frames within a fixed radius R
(``models.hifigan.receptive_field_frames``). Decoding a window of
``chunk + 2*R`` frames reproduces the monolithic decode over the interior
``chunk`` frames: the kept samples see the same input frames and the same
weights, and windows at the sequence edges are anchored to the true edge, so
the convolutions' zero padding coincides with the monolithic one.

The features stay on the device: a window is the slice
``feats[:, start:start + window]`` of the tensor the caller passes in (no
upload per chunk); each chunk comes back to the host as one small copy. With
the generator in ``eval()`` every window runs its 36 MRF layers (CSMSC)
through ``ops/resblock.fused_resblock_layer``, so on the card each window
decode launches ``csrc/resblock.cu`` as the monolithic decode does. Every
window of one decoder has one shape, ``[B, chunk + 2R, C]``.

The int8 decoder (``ops/int8_generator.Int8Decoder``) streams the same way,
through :meth:`from_feature_fn` with the fp32 generator's config: the int8
graph is the generator's with every conv quantized, so it has the same R,
and its scales are static, so its chunks equal its monolithic decode in the
interior, as the fp32 chunks equal theirs.

Cost: (chunk + 2R) / chunk of the monolithic decode's work (R = 20 frames
for the CSMSC recipe, so chunk 64 costs about 1.6x) while the time to the
first audio drops from decode(T) to decode(chunk + 2R).
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from msmctts_tpu_torch.models.hifigan import generator_upsample_ratio, receptive_field_frames

__all__ = ["StreamingDecoder"]


class StreamingDecoder:
    """Chunked decode over a window function.

    ``window_decode_fn(features, start)`` decodes the window
    ``features[:, start:start + window_frames]`` to ``window_frames * hop``
    samples (trailing axes are flattened); ``full_decode_fn(features)`` the
    whole sequence. Use the factories (:meth:`from_generator`,
    :meth:`from_feature_fn`) rather than building one by hand.
    """

    def __init__(
        self,
        window_decode_fn: Callable,
        full_decode_fn: Callable,
        hop: int,
        context_frames: int,
        chunk_frames: int = 64,
    ):
        if chunk_frames < 1:
            raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
        self._window_decode = window_decode_fn
        self._full_decode = full_decode_fn
        self.hop = int(hop)
        self.context_frames = int(context_frames)
        self.chunk_frames = int(chunk_frames)
        self.window_frames = self.chunk_frames + 2 * self.context_frames

    # -- factories ---------------------------------------------------------

    @classmethod
    def from_feature_fn(
        cls,
        decode_fn: Callable,
        decoder_config: dict,
        chunk_frames: int = 64,
        context_frames: Optional[int] = None,
    ) -> "StreamingDecoder":
        """Stream any features -> waveform callable ([B, T, C] ->
        [B, T * hop, ...]) with the receptive field of ``decoder_config``."""
        if context_frames is None:
            context_frames = receptive_field_frames(decoder_config)
        window = chunk_frames + 2 * context_frames
        return cls(
            lambda feats, start: decode_fn(feats[:, start:start + window]),
            decode_fn,
            generator_upsample_ratio(decoder_config),
            context_frames,
            chunk_frames,
        )

    @classmethod
    def from_generator(
        cls,
        generator: torch.nn.Module,
        decoder_config: dict,
        chunk_frames: int = 64,
        context_frames: Optional[int] = None,
    ) -> "StreamingDecoder":
        """Stream a ``HifiGANGenerator`` (or any module mapping [B, T, C] ->
        [B, T * hop, 1]). It must be in ``eval()`` mode: that is the
        inference graph, with the fused MRF layers."""
        if generator.training:
            raise RuntimeError("streaming decode needs the generator in eval() mode")
        return cls.from_feature_fn(generator, decoder_config, chunk_frames, context_frames)

    # -- streaming ---------------------------------------------------------

    @torch.inference_mode()
    def stream(self, features) -> Iterator[np.ndarray]:
        """Yield waveform chunks [B, <=chunk_frames*hop] left to right;
        their concatenation equals the monolithic decode of ``features``
        [B, T, C] (a tensor on the decoder's device, or an array, which is
        taken as a CPU tensor). Utterances no longer than one window fall
        back to a single full decode."""
        features = torch.as_tensor(features)
        if features.dim() != 3:
            raise ValueError(f"features must be [B, T, C], got {tuple(features.shape)}")
        b, t, _ = features.shape
        s, r, w, hop = self.chunk_frames, self.context_frames, self.window_frames, self.hop

        if t <= w:
            wav = self._full_decode(features)
            yield wav.reshape(b, -1)[:, : t * hop].cpu().numpy()
            return

        for i in range(math.ceil(t / s)):
            keep_lo = i * s
            keep_hi = min(t, keep_lo + s)
            # Clamp the window inside the sequence: at the edges the
            # window boundary coincides with the true sequence boundary,
            # so conv zero padding matches the monolithic decode; in the
            # interior the kept region sits >= R frames from both window
            # edges, outside the padding's reach.
            start = min(max(keep_lo - r, 0), t - w)
            wav = self._window_decode(features, start).reshape(b, -1)
            off = (keep_lo - start) * hop
            yield wav[:, off : off + (keep_hi - keep_lo) * hop].cpu().numpy()

    def decode(self, features) -> np.ndarray:
        """Convenience: concatenate all chunks ([B, T*hop])."""
        return np.concatenate(list(self.stream(features)), axis=1)
