"""Quantization-aware fine-tuning (QAT) of the int8 HiFi-GAN decoder
(counterpart of ``msmctts_tpu/ops/qat_int8.py``).

Post-training int8 (``ops/int8_generator.py``) leaves a per-tensor rounding
error that no calibration removes; a brief straight-through fine-tune of the
folded decoder kernels through a fake-quantized twin of the serving graph
moves the weights to points the int8 grid represents well.

``qat_generator_apply`` is that twin: site for site ``int8_generator_apply``
(conv_pre, each upsampling and its MRF blocks, float conv_post, tanh), every
quantized conv computed in fp32 on fake-quantized operands:

* weights: per-output-channel symmetric int8 of the folded kernel after the
  SmoothQuant ``s_in`` multiply, as serving quantizes them, the scale
  detached, the rounding passed straight through;
* activations: the static per-tensor scales of the serving calibration,
  after the matching ``1 / s_in`` divide; straight through again.

Both grids are the serving quantizer's own (its quantizer, smoothing and
activation observer are reused from ``ops/int8_generator.py``), so the
forward equals the true int8 decode up to fp32-vs-int32 accumulation. The
convs are ``F.conv1d`` / ``F.conv_transpose1d``, as the JAX package computes
them with XLA convolutions outside any Pallas kernel. ``unfold_to_weight_norm``
writes the fine-tuned kernels back into the checkpoint's weight-norm pairs
(v = w, g = ||w||), so the result serves through ``Int8Decoder`` unchanged.

Tool: ``msmctts_tpu_torch/tools/qat_int8.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from msmctts_tpu_torch.ops.int8_generator import (
    GEN_LRELU,
    _conv1d,
    _conv_transpose1d,
    _fold_generator_params,
    _lrelu,
    _observe_act_amax,
    _quantize_folded,
    _scales_from_amax,
    build_smoothing,
    qparams_to,
)


def fold_decoder_params(generator) -> dict:
    """A trained port ``HifiGANGenerator`` -> ``{site: {"w", "bias"}}`` of
    fp32 tensors on the generator's device (weight norm folded; kernels
    [k, in, out]), the site names of the int8 qparams and scales. The
    tensors are fresh leaves: the caller makes them trainable."""
    device = next(generator.parameters()).device
    as_t = lambda a: None if a is None else torch.as_tensor(a, device=device)
    return {site: {"w": as_t(w), "bias": as_t(b)} for site, (w, b) in _fold_generator_params(generator).items()}


def _numpy(x):
    return None if x is None else np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def unfold_to_weight_norm(folded: dict, params: dict, decoder_config: dict) -> dict:
    """Write folded kernels back into a decoder's weight-norm params subtree
    (the checkpoint's JAX layout, numpy leaves): ``v = w``, ``g = ||w||``
    over every axis but the output channels' (the input channels' for a
    transposed conv), without keepdims, so that the model's fold
    ``g * v / ||v||`` gives back ``w``. Other entries of ``params`` stay."""

    def wn(site, transposed=False):
        w = _numpy(folded[site]["w"])
        norm_axes = (0, 2) if transposed else tuple(range(w.ndim - 1))
        g = np.sqrt(np.sum(w * w, axis=norm_axes))
        node = {"v": w, "g": np.maximum(g, 1e-12).astype(np.float32)}
        if folded[site].get("bias") is not None:
            node["bias"] = _numpy(folded[site]["bias"])
        return node

    out = dict(params)
    out["conv_pre"] = wn("conv_pre")
    for i in range(len(decoder_config["upsample_rates"])):
        out[f"up_{i}"] = wn(f"up_{i}", transposed=True)
        for j in range(len(decoder_config["resblock_kernel_sizes"])):
            prefix = f"resblock_{i}_{j}/"
            out[f"resblock_{i}_{j}"] = {site[len(prefix):]: wn(site) for site in folded if site.startswith(prefix)}
    out["conv_post"] = wn("conv_post")
    return out


def calibrate_from_folded(folded: dict, feats, decoder_config: dict, smooth_alpha=1.0, headroom: float = 1.1):
    """The serving calibration of ``Int8Decoder.calibrate`` from a folded
    tree (fine-tuned or not) and decoder inputs ``feats`` [B, T, C] on any
    device: per-site static activation scales (python floats) and the
    SmoothQuant vectors (``site -> numpy [C_in]``, None with
    ``smooth_alpha`` None). The QAT tool refreshes it as the weights move,
    so that it trains on the grid a fresh serving calibration would build."""
    flat = {site: (_numpy(node["w"]), _numpy(node.get("bias"))) for site, node in folded.items()}
    qparams = qparams_to(_quantize_folded(flat, decoder_config), feats.device)
    amax = _observe_act_amax(qparams, [feats], decoder_config)
    smooth = None
    if smooth_alpha is not None:
        smooth = build_smoothing(flat, amax, smooth_alpha)
        amax = {site: a / smooth[site] if site in smooth else a for site, a in amax.items()}
    return _scales_from_amax(amax, headroom), smooth


# ------------------------------------------------------------- fake quant
def _ste(x, q):
    """Straight-through estimator: forward ``x + (q - x)``, gradient identity."""
    return x + (q - x).detach()


def fake_quant_weight(w, s_in=None):
    """Per-output-channel symmetric int8 fake-quant of a folded kernel
    [k, in, out], on the grid of ``_quantize_folded_kernel`` (the same
    SmoothQuant multiply, amax / 127 scale and clip)."""
    if s_in is not None:
        shape = [1] * w.dim()
        shape[-2] = w.shape[-2]
        w = w * torch.as_tensor(s_in, dtype=w.dtype, device=w.device).reshape(shape)
    scale = torch.amax(torch.abs(w), dim=tuple(range(w.dim() - 1))) / _scalar(127.0, w.device)
    scale = torch.clamp(scale, min=1e-12).detach()
    q = torch.clamp(torch.round(w / scale), -127.0, 127.0) * scale
    return _ste(w, q)


def _scalar(value, device):
    """An fp32 0-d tensor made on ``device`` by a fill, no host copy. A
    division by it is a division: by a python number, a CUDA tensor is
    multiplied by the number's reciprocal, which the grids must not be."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.full((), float(np.float32(value)), dtype=torch.float32, device=device)


def fake_quant_act(x, scale, s_in=None):
    """Static per-tensor int8 fake-quant of an activation with a calibrated
    ``scale`` (after the SmoothQuant divide by ``s_in``): the dequantized
    value the serving conv sees. The scale is the fp32 ``scale`` and x is
    divided by it, as the JAX package's QAT graph does."""
    xf = x.float()
    if s_in is not None:
        xf = xf / torch.as_tensor(s_in, dtype=torch.float32, device=xf.device)
    s = _scalar(scale, xf.device)
    q = torch.clamp(torch.round(xf / s), -127.0, 127.0) * s
    return _ste(xf, q)


def _fq_conv(node, x, padding: int, dilation: int, scale, s_in):
    xq = fake_quant_act(x, scale, s_in)
    wq = fake_quant_weight(node["w"], s_in)
    return _conv1d(xq, wq, node.get("bias"), padding=padding, dilation=dilation)


def _fq_conv_transpose(node, x, stride: int, padding: int, scale, s_in):
    xq = fake_quant_act(x, scale, s_in)
    wq = fake_quant_weight(node["w"], s_in)
    return _conv_transpose1d(xq, wq, node.get("bias"), stride, padding)


def qat_generator_apply(folded: dict, x, decoder_config: dict, act_scales: dict, smooth=None):
    """Differentiable fake-quant twin of ``int8_generator_apply``.

    folded: ``fold_decoder_params``'s tree (the trainable leaves);
    act_scales: site -> float static scale; smooth: site -> [C_in]
    SmoothQuant vector (a missing site has no fold). x [B, T, num_mels] ->
    [B, T * prod(upsample_rates), 1] fp32."""
    rates = list(decoder_config["upsample_rates"])
    uks = list(decoder_config["upsample_kernel_sizes"])
    rks = list(decoder_config["resblock_kernel_sizes"])
    rds = [list(d) for d in decoder_config["resblock_dilation_sizes"]]
    smooth = smooth or {}

    x = _fq_conv(folded["conv_pre"], x.float(), 3, 1, act_scales["conv_pre"], smooth.get("conv_pre"))
    for i, (u, k) in enumerate(zip(rates, uks)):
        x = _lrelu(x, GEN_LRELU)
        x = _fq_conv_transpose(folded[f"up_{i}"], x, u, (k - u) // 2, act_scales[f"up_{i}"], smooth.get(f"up_{i}"))
        acc = None
        for j, rk in enumerate(rks):
            h = x
            for di, d in enumerate(rds[j]):
                site = f"resblock_{i}_{j}/conv1_{di}"
                y = _fq_conv(folded[site], _lrelu(h), (rk - 1) // 2 * d, d, act_scales[site], smooth.get(site))
                site = f"resblock_{i}_{j}/conv2_{di}"
                y = _fq_conv(folded[site], _lrelu(y), (rk - 1) // 2, 1, act_scales[site], smooth.get(site))
                h = h + y
            acc = h if acc is None else acc + h
        x = acc / len(rks)
    x = _lrelu(x, 0.01)  # torch's default slope (reference generator.py:52)
    node = folded["conv_post"]
    return torch.tanh(_conv1d(x, node["w"], node.get("bias"), padding=3))
