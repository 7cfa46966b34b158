"""Operations and bytes of the TTS model's layers, from the configuration's
shapes and the inputs' own lengths, whatever implements them.

An operation is a multiply or an add: a multiply-add counts 2. Bytes count
each input read once and each output written once, in float32. The least
time of a call is the larger of its operations over the peak rate and its
bytes over the peak bandwidth (:func:`least_s`).

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): 495
TFLOP/s in TF32 on the tensor cores, 3.35 TB/s of HBM3. TF32 is the peak
because the MRF kernel already computes its fp32 products on the tensor
cores (three TF32 passes each, ``msmctts_tpu_torch/csrc/resblock.cu``); its
least time here counts one pass.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12
F32 = 4


def least_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """(least seconds, "operations" | "bytes")."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ------------------------------------------------------------------ kernels
def resblock_layer(B: int, T: int, C: int, k: int) -> Tuple[float, float]:
    """One MRF layer (``x + conv2(lrelu(conv1(lrelu(x), dilation d)))``,
    both convs C -> C with k taps) over [B, T, C] -> (operations, bytes)."""
    flops = 4 * k * C * C * B * T
    nbytes = (2 * B * T * C + 2 * (k * C * C + C)) * F32
    return flops, nbytes


def snap(N: int, H: int, d: int, K: int) -> Tuple[float, float]:
    """Nearest-codeword search of N rows of H heads of d against K codewords
    a head: distances, the argmin, the codewords gathered."""
    flops = 2 * N * H * d * K + 3 * N * H * K
    nbytes = (N * H * d * 2 + H * d * K + N * H) * F32
    return flops, nbytes


def snap_stats(N: int, valid: int, H: int, d: int, K: int) -> Tuple[float, float]:
    """The snap and the masked statistics of its ``valid`` rows: counts
    [H, K] and sums [H, d, K]."""
    flops = 2 * N * H * d * K + 3 * N * H * K + valid * H * (2 * d + 1)
    nbytes = (N * H * d * 2 + H * d * K + N + N * H + H * K + H * d * K) * F32
    return flops, nbytes


def mrf_layers(cfg: dict, B: int, frames: int) -> List[Tuple[int, int, int, int]]:
    """(B, T, C, k) of every MRF layer of one HiFi-GAN decode of ``frames``."""
    out, T, C = [], frames, cfg["upsample_initial_channel"]
    for u in cfg["upsample_rates"]:
        T, C = T * u, C // 2
        for k, dil in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]):
            out += [(B, T, C, k)] * len(dil)
    return out


# ------------------------------------------------------------------ layers
def _fft(T: int, d: int, cfg: dict) -> float:
    """Operations of FFT blocks over T positions of width d."""
    H, dk, dv, inner = cfg["n_head"], cfg["d_k"], cfg["d_v"], cfg["d_inner"]
    k = cfg.get("fft_conv1d_kernel", 3)
    per = (2 * T * d * H * (2 * dk + dv)  # fused q, k, v
           + 2 * T * T * H * (dk + dv)  # scores and their weighted sum
           + 2 * T * H * dv * d  # output projection
           + 2 * 2 * T * d * inner * k)  # the two convs of the FFN
    return per * cfg["n_layers"]


def decoder_flops(cfg: dict, frames: int) -> float:
    """HiFi-GAN over ``frames`` input frames of ``cfg["num_mels"]`` channels."""
    c0 = cfg["upsample_initial_channel"]
    flops, T, C = 2 * frames * cfg["num_mels"] * c0 * 7, frames, c0
    for u, k in zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"]):
        flops += 2 * T * C * (C // 2) * k  # transposed conv: each input frame meets k taps
        T, C = T * u, C // 2
    flops += sum(4 * k * c * c * b * t for b, t, c, k in mrf_layers(cfg, 1, frames))
    return flops + 2 * T * C * 7  # conv_post


def request_flops(task: dict, phones: int, frames: int) -> float:
    """Operations one request needs: its own phones and frames through the
    predictor (one encoder pass), the autoencoder's synthesis and the
    decoder, as the model defines them (no padding, no repeated pass)."""
    p, a = task["predictor"], task["autoencoder"]
    M, P = p["n_model_size"], p["n_pred_size"]
    scales = list(p["n_pred_scale"])
    q = a["quantizer_config"]
    H, K = q["n_heads"], q["embedding_sizes"]
    d = P // H
    ad = p["adaptor_config"]
    fk, fs = ad.get("duration_predictor_kernel_size", 3), ad["duration_predictor_filter_size"]
    flops = _fft(phones, M, p["encoder_config"])
    flops += 2 * phones * (M * fs * fk + fs * fs * fk + fs)  # duration head
    T = frames
    for s in scales[::-1]:  # the downsampling convs, each at the rate it reads
        flops += 2 * T * M * M * (2 * s + 1)
        T = math.ceil(T / s)
    stage_T = [math.ceil(frames / math.prod(scales[i:])) for i in range(len(scales))]
    for i, T in enumerate(stage_T):
        d_in = M if i == 0 else 2 * M + P
        flops += 2 * T * d_in * M + _fft(T, M, p["decoder_config"]) + 2 * T * M * P
        flops += 2 * snap(T, H, d, K)[0]  # the predictor's snap and the re-quantization
    Ma = a["n_model_size"]
    pr = q["prior_config"]
    for i, T in enumerate(stage_T):
        if i > 0:
            n, k = pr.get("n_layers", 4), pr.get("kernel_size", 5)
            flops += n * 2 * T * Ma * 2 * Ma * k + 2 * T * Ma * Ma * (2 * (n - 1) + 1)
        d_in = P if i == 0 else Ma + P
        flops += 2 * T * d_in * P + 2 * T * P * Ma  # post-processor
    if a.get("frame_decoder_config") is not None:
        flops += _fft(frames, Ma, a["frame_decoder_config"])
    return flops + decoder_flops(dict(a["decoder_config"], num_mels=Ma), frames)


def predict_batch_snaps(task: dict, B: int, frames: int) -> List[Tuple[float, float]]:
    """(operations, bytes) of every snap of one predicted batch at one
    frame bucket: per stage, the predictor's snap and the re-quantization."""
    p, q = task["predictor"], task["autoencoder"]["quantizer_config"]
    H, K = q["n_heads"], q["embedding_sizes"]
    d = p["n_pred_size"] // H
    scales = list(p["n_pred_scale"])
    return [snap(B * math.ceil(frames / math.prod(scales[i:])), H, d, K)
            for i in range(len(scales)) for _ in range(2)]


def bounds(calls: Sequence[Tuple[float, float]]) -> Dict[str, float]:
    """Sum of least times of calls -> {"least_s", "ops_bound_calls", "bytes_bound_calls"}."""
    total, kinds = 0.0, {"operations": 0, "bytes": 0}
    for flops, nbytes in calls:
        t, kind = least_s(flops, nbytes)
        total += t
        kinds[kind] += 1
    return {"least_s": total, "ops_bound_calls": kinds["operations"], "bytes_bound_calls": kinds["bytes"]}
