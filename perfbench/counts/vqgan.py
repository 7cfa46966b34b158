"""Operations of one GAN-phase train step of the MSMC-VQ-GAN autoencoder
recipe, from the configuration's shapes and the batch's padded shape, as
``perfbench/counts/tts.py`` counts them (a multiply-add is 2).

A step runs the autoencoder forward once and its backward (weights and
inputs: twice the forward), and the discriminator on four windows: the
detached fake and the real one for its own update (forward, and a backward
for its weights: once the forward each), then the fake and the real one
against the updated discriminator (the real one under no gradient), with a
backward to the fake's input only. That is 3 autoencoder forwards and 7
discriminator forwards. The loss's STFTs, norms and elementwise work are
left out: under one percent of the products.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from perfbench.counts.tts import _fft, decoder_flops, snap_stats


def autoencoder_flops(a: dict, B: int, T: int, window_frames: int) -> float:
    """The autoencoder's forward over [B, T] mel frames, the decoder over
    each row's window."""
    M, in_dim = a["n_model_size"], a["in_dim"]
    enc, q = a["encoder_config"], a["quantizer_config"]
    dims, H, K = q["embedding_dims"], q["n_heads"], q["embedding_sizes"]
    flops = 2 * B * T * in_dim * M
    rates, t = [], T
    for s in enc["downsample_scales"]:
        t = t // s
        rates.append(t)
        flops += B * _fft(t, M, enc)
    pr = q["prior_config"]
    n, k = pr.get("n_layers", 4), pr.get("kernel_size", 5)
    for i, t in enumerate(rates[::-1]):  # coarsest first
        N = B * t
        if i > 0:  # the prior predictor's residual stack and projection
            flops += n * 2 * N * M * 2 * M * k + 2 * N * M * M * (2 * (n - 1) + 1) + 2 * N * M * dims
        d_in = M if i == 0 else 2 * M
        flops += 2 * N * (d_in * dims + dims * dims)  # pre-processor
        flops += snap_stats(N, N, H, dims // H, K)[0]
        flops += 2 * N * ((dims if i == 0 else M + dims) * dims + dims * M)  # post-processor
    if a.get("frame_decoder_config") is not None:
        flops += B * _fft(T, M, a["frame_decoder_config"])
    flops += 2 * B * T * M * in_dim  # mel predictor
    return flops + B * decoder_flops(dict(a["decoder_config"], num_mels=M), window_frames)


def _conv2d(c_in: int, c_out: int, kh: int, kw: int, h: int, w: int) -> float:
    return 2.0 * c_in * c_out * kh * kw * h * w


def discriminator_flops(d: dict, B: int, samples: int) -> float:
    """UnivNet's spectrogram (MRD) and period (MPD) discriminators over
    [B, samples]."""
    flops = 0.0
    mrd = d["mrd_config"]
    for hop, hc in zip(mrd["hop_lengths"], mrd["hidden_channels"]):
        n_fft = 4 * hop
        bins, frames = n_fft // 2 + 1, samples // hop + 1
        flops += 2 * frames * n_fft * 2 * bins  # the windowed DFT
        if mrd.get("mel_scale", True):
            flops += 2 * frames * bins * bins
        c_in = 2 if mrd.get("domain", "double") == "double" else 1
        h, w = bins, frames
        for c, s in [(hc // 32, 1), (hc // 16, 2), (hc // 8, 1), (hc // 4, 2), (hc // 2, 1), (hc, 2), (1, 1)]:
            h, w = (h + 2 - 3) // s + 1, (w + 2 - 3) // s + 1
            flops += _conv2d(c_in, c, 3, 3, h, w)
            c_in = c
    mpd = d["mpd_config"]
    ch, top = mpd.get("channels", 32), mpd.get("max_channels", 1024)
    for p in mpd["periods"]:
        h = math.ceil(samples / p)
        c_in = 1
        for c in [ch, ch * 4, min(top, ch * 16), min(top, ch * 32)]:
            h = (h + 4 - 5) // 3 + 1
            flops += _conv2d(c_in, c, 5, 1, h, p)
            c_in = c
        flops += _conv2d(c_in, c_in, 5, 1, h, p) + _conv2d(c_in, 1, 3, 1, h, p)
    return B * flops


def step_flops(program: dict, B: int, T: int) -> float:
    """Operations of one GAN step on a batch padded to [B, T] frames."""
    task, tr, ds = program["task"], program["trainer"], program["dataset"]
    shift = ds["frameshift"][ds["feature"].index("mel")]
    samples = int(tr["sample_lengths"])
    ae = autoencoder_flops(task["autoencoder"], B, T, samples // shift)
    return 3 * ae + 7 * discriminator_flops(task["discriminator"], B, samples)


def step_snaps(program: dict, B: int, T: int, lengths: List[int]) -> List[Tuple[float, float]]:
    """(operations, bytes) of the step's two statistics calls, coarsest first."""
    a = program["task"]["autoencoder"]
    q = a["quantizer_config"]
    H, K, dims = q["n_heads"], q["embedding_sizes"], q["embedding_dims"]
    out = []
    scale = math.prod(a["encoder_config"]["downsample_scales"])
    for s in (scale, 1):
        valid = sum(-(-n // s) for n in lengths)
        out.append(snap_stats(B * (T // s), valid, H, dims // H, K))
    return out
