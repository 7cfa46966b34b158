"""Weights carried between the JAX package's variables trees and the port.

A JAX variables tree (nested dicts of numpy arrays: ``params``,
``codebook``) maps onto a port ``state_dict`` keyed by the reference torch
parameter names, and back. The ``*_from_jax`` functions are the port's own
copy of the ``*_inv`` converters of ``msmctts_tpu/utils/torch_compat.py``
(468-587), and the ``*_to_jax`` functions of its forward converters, with
one change: a multi-head codebook stays one [H, d, K] tensor
(``<prefix>.embed``, ``.cluster_size`` [H, K], ``.embed_avg``) instead of
one buffer per head.

Layouts translated:

=========================  =====================  ========================
JAX (flax)                 shape                  port (torch)
=========================  =====================  ========================
Dense kernel               [in, out]              Linear.weight [out, in]
Conv kernel                [k, in, out]           Conv1d.weight [out, in, k]
Dense on a 1x1 conv        [in, out]              Conv1x1.weight [out, in, 1]
WNConv v, g                [k, in, out], [out]    weight_v [out, in, k],
                                                  weight_g [out, 1, 1]
WNConvTranspose1d v, g     [k, in, out], [in]     weight_v [in, out, k],
                                                  weight_g [in, 1, 1]
WNConv (2-D) v, g          [kh, kw, in, out],     weight_v [out, in, kh, kw],
                           [out]                  weight_g [out, 1, 1, 1]
LayerNorm scale, bias      [d]                    weight, bias [d]
=========================  =====================  ========================
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from msmctts_tpu_torch.ops.convs import refold
from msmctts_tpu_torch.parallel.mesh import max_deviation_from_rank0

StateDict = Dict[str, np.ndarray]


def _np(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _pre(prefix: str) -> str:
    return prefix + "." if prefix else ""


# ------------------------------------------------------------ JAX -> port


def dense_from_jax(p: dict, prefix: str) -> StateDict:
    out = {f"{prefix}.weight": _np(p["kernel"]).T.copy()}
    if "bias" in p:
        out[f"{prefix}.bias"] = _np(p["bias"])
    return out


def conv1d_from_jax(p: dict, prefix: str) -> StateDict:
    out = {f"{prefix}.weight": _np(p["kernel"]).transpose(2, 1, 0).copy()}
    if "bias" in p:
        out[f"{prefix}.bias"] = _np(p["bias"])
    return out


def conv1x1_from_jax(p: dict, prefix: str) -> StateDict:
    out = {f"{prefix}.weight": _np(p["kernel"]).T[:, :, None].copy()}
    if "bias" in p:
        out[f"{prefix}.bias"] = _np(p["bias"])
    return out


def wn_conv_from_jax(p: dict, prefix: str) -> StateDict:
    v = _np(p["v"])
    if v.ndim == 3:  # [k, in, out] -> [out, in, k]
        axes, g_shape = (2, 1, 0), (-1, 1, 1)
    else:  # [kh, kw, in, out] -> [out, in, kh, kw]
        axes, g_shape = (3, 2, 0, 1), (-1, 1, 1, 1)
    out = {
        f"{prefix}.weight_v": v.transpose(axes).copy(),
        f"{prefix}.weight_g": _np(p["g"]).reshape(g_shape),
    }
    if "bias" in p:
        out[f"{prefix}.bias"] = _np(p["bias"])
    return out


def wn_conv_transpose1d_from_jax(p: dict, prefix: str) -> StateDict:
    out = {
        f"{prefix}.weight_v": _np(p["v"]).transpose(1, 2, 0).copy(),
        f"{prefix}.weight_g": _np(p["g"]).reshape(-1, 1, 1),
    }
    if "bias" in p:
        out[f"{prefix}.bias"] = _np(p["bias"])
    return out


def layer_norm_from_jax(p: dict, prefix: str) -> StateDict:
    return {f"{prefix}.weight": _np(p["scale"]), f"{prefix}.bias": _np(p["bias"])}


def fft_blocks_from_jax(params: dict, prefix: str = "") -> StateDict:
    pre = _pre(prefix)
    out: StateDict = {}
    for name, block in params.items():
        if not name.startswith("FFTBlock_"):
            continue
        base = f"{pre}layer_stack.{int(name.split('_')[-1])}"
        attn, ffn = block["MultiHeadAttention_0"], block["ConvFFN_0"]
        out.update(dense_from_jax(attn["qkv"], f"{base}.slf_attn.linear"))
        out.update(dense_from_jax(attn["out"], f"{base}.slf_attn.fc"))
        out.update(layer_norm_from_jax(attn["LayerNorm_0"], f"{base}.slf_attn.layer_norm"))
        out.update(conv1d_from_jax(ffn["w1"], f"{base}.pos_ffn.w_1"))
        out.update(conv1d_from_jax(ffn["w2"], f"{base}.pos_ffn.w_2"))
        out.update(layer_norm_from_jax(ffn["LayerNorm_0"], f"{base}.pos_ffn.layer_norm"))
    return out


def quantize_from_jax(codebook: dict, prefix: str = "") -> StateDict:
    pre = _pre(prefix)
    return {f"{pre}{k}": _np(codebook[k]) for k in ("embed", "cluster_size", "embed_avg")}


def res_stack_from_jax(params: dict, prefix: str = "") -> StateDict:
    pre = _pre(prefix)
    out: StateDict = {}
    for name, p in params.items():
        if name.startswith("in_"):
            out.update(wn_conv_from_jax(p, f"{pre}in_layers.{name.split('_')[-1]}"))
        elif name.startswith("res_skip_"):
            out.update(wn_conv_from_jax(p, f"{pre}res_skip_layers.{name.split('_')[-1]}"))
        elif name == "cond_layer":
            out.update(wn_conv_from_jax(p, f"{pre}cond_layer"))
    return out


def prior_predictor_from_jax(params: dict, prefix: str = "") -> StateDict:
    pre = _pre(prefix)
    out = res_stack_from_jax(params["enc"], f"{pre}enc")
    out.update(conv1x1_from_jax(params["proj"], f"{pre}proj"))
    return out


def encoder_from_jax(params: dict, prefix: str = "") -> StateDict:
    """JAX ``models.modules.Encoder`` params -> port state_dict (``pre`` and
    ``proj`` are Dense there, 1x1 convs here)."""
    pre = _pre(prefix)
    out = conv1x1_from_jax(params["pre"], f"{pre}pre")
    out.update(res_stack_from_jax(params["enc"], f"{pre}enc"))
    out.update(conv1x1_from_jax(params["proj"], f"{pre}proj"))
    return out


def hifigan_generator_from_jax(params: dict, prefix: str = "") -> StateDict:
    pre = _pre(prefix)
    out = wn_conv_from_jax(params["conv_pre"], f"{pre}conv_pre")
    out.update(wn_conv_from_jax(params["conv_post"], f"{pre}conv_post"))
    ups = sorted(int(n.split("_")[-1]) for n in params if n.startswith("up_"))
    rbs = [n for n in params if n.startswith("resblock_")]
    num_kernels = len(rbs) // max(len(ups), 1)
    for i in ups:
        out.update(wn_conv_transpose1d_from_jax(params[f"up_{i}"], f"{pre}ups.{i}"))
    for name in rbs:
        _, i, j = name.split("_")
        r = int(i) * num_kernels + int(j)
        for m_name, p in params[name].items():
            kind, m = m_name.rsplit("_", 1)
            tgt = {"conv1": "convs1", "conv2": "convs2", "conv": "convs"}[kind]
            out.update(wn_conv_from_jax(p, f"{pre}resblocks.{r}.{tgt}.{m}"))
    return out


def ms_generator_from_jax(params: dict, prefix: str = "") -> StateDict:
    """``MSGenerator``: a ``HifiGANGenerator`` named ``generator``."""
    return hifigan_generator_from_jax(params["generator"], f"{_pre(prefix)}generator")


def generator_from_jax(params: dict, prefix: str = "") -> StateDict:
    """Any decoder family: ``ISTFTGenerator`` has the HiFi-GAN's names (its
    ``conv_post`` 2 * bins wide), ``MSGenerator`` nests one under
    ``generator``."""
    return (ms_generator_from_jax if "generator" in params else hifigan_generator_from_jax)(params, prefix)


def multi_stage_quantizer_from_jax(params: dict, codebook: dict, prefix: str = "",
                                   batch_stats: Optional[dict] = None) -> StateDict:
    """The quantizer's params and codebook, and with ``norm: True`` its
    ``batch_stats`` (``prenorm_i`` {mean, var} -> ``preprocessor.i.3``)."""
    pre = _pre(prefix)
    out: StateDict = {}
    for name in codebook:
        i = int(name.split("_")[-1])
        out.update(quantize_from_jax(codebook[name], f"{pre}quantizer.{i}"))
        out.update(conv1x1_from_jax(params[f"pre_{i}_a"], f"{pre}preprocessor.{i}.0"))
        out.update(conv1x1_from_jax(params[f"pre_{i}_b"], f"{pre}preprocessor.{i}.2"))
        out.update(dense_from_jax(params[f"post_{i}_a"], f"{pre}postprocessor.{i}.0"))
        out.update(dense_from_jax(params[f"post_{i}_b"], f"{pre}postprocessor.{i}.2"))
        if f"prior_{i}" in params:
            out.update(prior_predictor_from_jax(params[f"prior_{i}"], f"{pre}predictor.{i}"))
        if f"up_{i}" in params:
            out.update(wn_conv_transpose1d_from_jax(params[f"up_{i}"], f"{pre}transposed_conv.{i}"))
        if batch_stats and f"prenorm_{i}" in batch_stats:
            out[f"{pre}preprocessor.{i}.3.running_mean"] = _np(batch_stats[f"prenorm_{i}"]["mean"])
            out[f"{pre}preprocessor.{i}.3.running_var"] = _np(batch_stats[f"prenorm_{i}"]["var"])
    return out


def msmc_vqgan_from_jax(variables: dict, prefix: str = "") -> StateDict:
    """JAX MSMCVQGAN variables {'params', 'codebook'[, 'batch_stats']} ->
    port state_dict."""
    pre = _pre(prefix)
    params = variables["params"]
    out = dense_from_jax(params["in_linear"], f"{pre}in_linear")
    for name, block in params["encoder"].items():
        out.update(fft_blocks_from_jax(block, f"{pre}encoder.encoders.{int(name.split('_')[-1])}"))
    out.update(
        multi_stage_quantizer_from_jax(
            params["quantizer"], variables["codebook"]["quantizer"], f"{pre}quantizer",
            (variables.get("batch_stats") or {}).get("quantizer"),
        )
    )
    out.update(generator_from_jax(params["decoder"], f"{pre}decoder"))
    if "frame_decoder" in params:
        out.update(fft_blocks_from_jax(params["frame_decoder"], f"{pre}frame_decoder"))
    if "mel_predictor" in params:
        out.update(dense_from_jax(params["mel_predictor"], f"{pre}mel_predictor"))
    return out


def duration_predictor_from_jax(params: dict, prefix: str = "") -> StateDict:
    pre = _pre(prefix)
    out = conv1d_from_jax(params["conv1"], f"{pre}conv1d_1")
    out.update(layer_norm_from_jax(params["LayerNorm_0"], f"{pre}layer_norm_1"))
    out.update(conv1d_from_jax(params["conv2"], f"{pre}conv1d_2"))
    out.update(layer_norm_from_jax(params["LayerNorm_1"], f"{pre}layer_norm_2"))
    out.update(dense_from_jax(params["Dense_0"], f"{pre}linear_layer"))
    return out


def multi_stage_predictor_from_jax(params: dict, prefix: str = "") -> StateDict:
    """JAX MultiStagePredictor params -> port state_dict."""
    pre = _pre(prefix)
    out: StateDict = {}
    embs = sorted(int(n.split("_")[-1]) for n in params if n.startswith("word_emb_"))
    if embs == [0]:
        out[f"{pre}word_emb.weight"] = _np(params["word_emb_0"]["embedding"])
    else:
        for i in embs:
            out[f"{pre}word_emb.{i}.weight"] = _np(params[f"word_emb_{i}"]["embedding"])
    out.update(fft_blocks_from_jax(params["encoder"], f"{pre}encoder"))
    out.update(
        duration_predictor_from_jax(
            params["upsampler"]["DurationPredictor_0"], f"{pre}upsampler.duration_predictor"
        )
    )
    for name in params:
        i = name.split("_")[-1]
        if name.startswith("downsampler_"):
            out.update(conv1d_from_jax(params[name], f"{pre}downsamplers.{i}"))
        elif name.startswith("dec_pre_"):
            out.update(dense_from_jax(params[name], f"{pre}decoders.{i}.0"))
        elif name.startswith("dec_blocks_"):
            out.update(fft_blocks_from_jax(params[name], f"{pre}decoders.{i}.1"))
        elif name.startswith("dec_out_"):
            out.update(dense_from_jax(params[name], f"{pre}decoders.{i}.2"))
    return out


def discriminator_r_from_jax(params: dict, prefix: str = "") -> StateDict:
    """The conv of stage i sits at index 1 of its ``nn.Sequential`` for
    stage 0 ([pad, conv]) and at 2 otherwise ([lrelu, pad, conv])."""
    pre = _pre(prefix)
    out: StateDict = {}
    for name, p in params.items():
        i = int(name.split("_")[-1])
        out.update(wn_conv_from_jax(p, f"{pre}discriminator.{i}.{1 if i == 0 else 2}"))
    return out


def discriminator_p_from_jax(params: dict, prefix: str = "") -> StateDict:
    pre = _pre(prefix)
    out = wn_conv_from_jax(params["conv_post"], f"{pre}conv_post")
    for name, p in params.items():
        if name != "conv_post":
            out.update(wn_conv_from_jax(p, f"{pre}convs.{int(name.split('_')[-1])}"))
    return out


def univnet_discriminator_from_jax(params: dict, prefix: str = "", periods=(2, 3, 5, 7, 11)) -> StateDict:
    """JAX UnivNetDiscriminator params -> port state_dict. ``periods`` must
    be the MPD config's: flax names a period discriminator ``disc_p{period}``,
    the port indexes them by position."""
    pre = _pre(prefix)
    out: StateDict = {}
    for name, p in params["mrd"].items():
        out.update(discriminator_r_from_jax(p, f"{pre}mrd.discriminators.{int(name.split('_')[-1])}"))
    for i, period in enumerate(periods):
        out.update(discriminator_p_from_jax(params["mpd"][f"disc_p{period}"], f"{pre}mpd.discriminators.{i}"))
    return out


def batch_norm_from_jax(p: dict, stats: Optional[dict], prefix: str) -> StateDict:
    """flax BatchNorm params {scale, bias} and its ``batch_stats`` {mean,
    var} -> ``tdnn.BatchNorm`` (no stats: flax's initial 0 / 1)."""
    scale = _np(p["scale"])
    out = {f"{prefix}.weight": scale, f"{prefix}.bias": _np(p["bias"])}
    out[f"{prefix}.running_mean"] = _np(stats["mean"]) if stats else np.zeros_like(scale)
    out[f"{prefix}.running_var"] = _np(stats["var"]) if stats else np.ones_like(scale)
    return out


def conv_relu_bn_from_jax(p: dict, stats: Optional[dict], prefix: str) -> StateDict:
    out = conv1d_from_jax(p["Conv_0"], f"{prefix}.conv")
    out.update(batch_norm_from_jax(p["BatchNorm_0"], (stats or {}).get("BatchNorm_0"), f"{prefix}.bn"))
    return out


def res2_conv_relu_bn_from_jax(p: dict, stats: Optional[dict], prefix: str) -> StateDict:
    out: StateDict = {}
    for name in p:
        if name.startswith("conv_"):
            i = name.split("_")[-1]
            out.update(conv1d_from_jax(p[name], f"{prefix}.convs.{i}"))
            out.update(batch_norm_from_jax(p[f"bn_{i}"], (stats or {}).get(f"bn_{i}"), f"{prefix}.bns.{i}"))
    return out


def se_connect_from_jax(p: dict, prefix: str) -> StateDict:
    out = dense_from_jax(p["Dense_0"], f"{prefix}.linear1")
    out.update(dense_from_jax(p["Dense_1"], f"{prefix}.linear2"))
    return out


def se_res2_block_from_jax(p: dict, stats: Optional[dict], prefix: str) -> StateDict:
    """An SE-Res2Block's ``in`` / ``res2`` / ``out`` / ``se`` are the port's
    ``0`` / ``1`` / ``2`` / ``3``."""
    stats = stats or {}
    out = conv_relu_bn_from_jax(p["in"], stats.get("in"), f"{prefix}.0")
    out.update(res2_conv_relu_bn_from_jax(p["res2"], stats.get("res2"), f"{prefix}.1"))
    out.update(conv_relu_bn_from_jax(p["out"], stats.get("out"), f"{prefix}.2"))
    out.update(se_connect_from_jax(p["se"], f"{prefix}.3"))
    return out


def attentive_stats_pool_from_jax(p: dict, prefix: str) -> StateDict:
    out = conv1x1_from_jax(p["Dense_0"], f"{prefix}.linear1")
    out.update(conv1x1_from_jax(p["Dense_1"], f"{prefix}.linear2"))
    return out


def ecapa_tdnn_from_jax(params: dict, stats: Optional[dict], prefix: str = "") -> StateDict:
    """JAX ECAPA_TDNN params and ``batch_stats`` -> port state_dict."""
    pre = _pre(prefix)
    stats = stats or {}
    out = conv_relu_bn_from_jax(params["layer1"], stats.get("layer1"), f"{pre}layer1")
    for n in (2, 3, 4):
        out.update(se_res2_block_from_jax(params[f"layer{n}"], stats.get(f"layer{n}"), f"{pre}layer{n}"))
    out.update(conv1x1_from_jax(params["conv"], f"{pre}conv"))
    out.update(attentive_stats_pool_from_jax(params["pooling"], f"{pre}pooling"))
    out.update(batch_norm_from_jax(params["bn1"], stats.get("bn1"), f"{pre}bn1"))
    out.update(dense_from_jax(params["linear"], f"{pre}linear"))
    out.update(batch_norm_from_jax(params["bn2"], stats.get("bn2"), f"{pre}bn2"))
    return out


def xvector_tdnn_from_jax(params: dict, stats: Optional[dict], prefix: str = "") -> StateDict:
    """JAX XVectorTDNN params and ``batch_stats`` -> port state_dict
    (``tdnn{i}`` / ``bn{i}`` / ``fc{i}`` / ``bn_fc{i}``, 1-based, are the
    port's ``tdnn.i`` / ``bn.i`` / ``fc.i`` / ``bn_fc.i``)."""
    pre = _pre(prefix)
    stats = stats or {}
    out: StateDict = {}
    for name, p in params.items():
        kind, i = re.match(r"([a-z_]+?)(\d+)$", name).groups()
        i = int(i) - 1
        if kind == "tdnn":
            out.update(conv1d_from_jax(p, f"{pre}tdnn.{i}"))
        elif kind == "fc":
            out.update(dense_from_jax(p, f"{pre}fc.{i}"))
        else:
            out.update(batch_norm_from_jax(p, stats.get(name), f"{pre}{kind}.{i}"))
    return out


def mams_encoder_from_jax(params: dict, prefix: str = "") -> StateDict:
    """JAX MAMSEncoder params -> port state_dict (``pitch_encoder`` c0-c3
    at the port's ``Sequential`` indices 0 / 2 / 4 / 6)."""
    pre = _pre(prefix)
    out: StateDict = {}
    for name, block in params.items():
        if name == "pitch_encoder":
            for j in range(4):
                out.update(conv1d_from_jax(block[f"c{j}"], f"{pre}pitch_encoder.{2 * j}"))
        else:
            out.update(fft_blocks_from_jax(block, f"{pre}encoders.{int(name.split('_')[-1])}"))
    return out


def attr_predictor_from_jax(params: dict, prefix: str = "") -> StateDict:
    """JAX AttrPredictor params -> port state_dict."""
    pre = _pre(prefix)
    out = res_stack_from_jax(params["enc"], f"{pre}enc")
    out.update(dense_from_jax(params["proj"], f"{pre}proj"))
    return out


def emb_autoencoder_from_jax(variables: dict, prefix: str = "") -> StateDict:
    """JAX variables {'params', 'codebook', 'batch_stats'} of any network of
    the QS-TTS family (``MSMCVQGANEmb``, ``KMeansVQGANEmb``, ``EmbVC``) ->
    port state_dict; what a network has decides which parts map."""
    pre = _pre(prefix)
    params = variables["params"]
    codebook = variables.get("codebook") or {}
    stats = variables.get("batch_stats") or {}
    out = dense_from_jax(params["in_linear"], f"{pre}in_linear")
    if "encoder" in params:
        out.update(mams_encoder_from_jax(params["encoder"], f"{pre}encoder"))
    if "quantizer" in params:
        out.update(multi_stage_quantizer_from_jax(params["quantizer"], codebook["quantizer"], f"{pre}quantizer",
                                                  stats.get("quantizer")))
    elif "embed" in codebook.get("quantizer", {}):  # the frozen k-means codebook [1, d, K]
        out[f"{pre}quantizer.embed"] = _np(codebook["quantizer"]["embed"])
    if "global_encoder" in params:
        out.update(ecapa_tdnn_from_jax(params["global_encoder"], stats.get("global_encoder"), f"{pre}global_encoder"))
    out.update(generator_from_jax(params["decoder"], f"{pre}decoder"))
    if "frame_decoder" in params:
        out.update(fft_blocks_from_jax(params["frame_decoder"], f"{pre}frame_decoder"))
    if "mel_predictor" in params:
        out.update(dense_from_jax(params["mel_predictor"], f"{pre}mel_predictor"))
    return out


# ------------------------------------------------------------ port -> JAX


def _sub(sd: StateDict, prefix: str) -> StateDict:
    if prefix and not prefix.endswith("."):
        prefix += "."
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _layer_indices(sd: StateDict, pattern: str):
    rx = re.compile(pattern)
    return sorted({int(m.group(1)) for k in sd if (m := rx.match(k))})


def dense_to_jax(sd: StateDict, prefix: str) -> dict:
    s = _sub(sd, prefix)
    out = {"kernel": _np(s["weight"]).T.copy()}
    if "bias" in s:
        out["bias"] = _np(s["bias"])
    return out


def conv1d_to_jax(sd: StateDict, prefix: str) -> dict:
    s = _sub(sd, prefix)
    out = {"kernel": _np(s["weight"]).transpose(2, 1, 0).copy()}
    if "bias" in s:
        out["bias"] = _np(s["bias"])
    return out


def conv1x1_to_jax(sd: StateDict, prefix: str) -> dict:
    s = _sub(sd, prefix)
    out = {"kernel": _np(s["weight"])[:, :, 0].T.copy()}
    if "bias" in s:
        out["bias"] = _np(s["bias"])
    return out


def wn_conv_to_jax(sd: StateDict, prefix: str) -> dict:
    s = _sub(sd, prefix)
    v = _np(s["weight_v"])
    axes = (2, 1, 0) if v.ndim == 3 else (2, 3, 1, 0)  # conv2d [out, in, kh, kw] -> [kh, kw, in, out]
    out = {"v": v.transpose(axes).copy(), "g": _np(s["weight_g"]).reshape(-1)}
    if "bias" in s:
        out["bias"] = _np(s["bias"])
    return out


def wn_conv_transpose1d_to_jax(sd: StateDict, prefix: str) -> dict:
    s = _sub(sd, prefix)
    out = {"v": _np(s["weight_v"]).transpose(2, 0, 1).copy(), "g": _np(s["weight_g"]).reshape(-1)}
    if "bias" in s:
        out["bias"] = _np(s["bias"])
    return out


def layer_norm_to_jax(sd: StateDict, prefix: str) -> dict:
    s = _sub(sd, prefix)
    return {"scale": _np(s["weight"]), "bias": _np(s["bias"])}


def fft_blocks_to_jax(sd: StateDict, prefix: str = "") -> dict:
    s = _sub(sd, prefix)
    params = {}
    for i in _layer_indices(s, r"layer_stack\.(\d+)\."):
        ls = _sub(s, f"layer_stack.{i}")
        params[f"FFTBlock_{i}"] = {
            "MultiHeadAttention_0": {
                "qkv": dense_to_jax(ls, "slf_attn.linear"),
                "out": dense_to_jax(ls, "slf_attn.fc"),
                "LayerNorm_0": layer_norm_to_jax(ls, "slf_attn.layer_norm"),
            },
            "ConvFFN_0": {
                "w1": conv1d_to_jax(ls, "pos_ffn.w_1"),
                "w2": conv1d_to_jax(ls, "pos_ffn.w_2"),
                "LayerNorm_0": layer_norm_to_jax(ls, "pos_ffn.layer_norm"),
            },
        }
    return params


def res_stack_to_jax(sd: StateDict, prefix: str = "") -> dict:
    s = _sub(sd, prefix)
    params = {}
    for i in _layer_indices(s, r"in_layers\.(\d+)\."):
        params[f"in_{i}"] = wn_conv_to_jax(s, f"in_layers.{i}")
    for i in _layer_indices(s, r"res_skip_layers\.(\d+)\."):
        params[f"res_skip_{i}"] = wn_conv_to_jax(s, f"res_skip_layers.{i}")
    if any(k.startswith("cond_layer.") for k in s):
        params["cond_layer"] = wn_conv_to_jax(s, "cond_layer")
    return params


def encoder_to_jax(sd: StateDict, prefix: str = "") -> dict:
    """Port ``Encoder`` state_dict -> JAX params."""
    s = _sub(sd, prefix)
    return {"pre": conv1x1_to_jax(s, "pre"), "enc": res_stack_to_jax(s, "enc"), "proj": conv1x1_to_jax(s, "proj")}


def prior_predictor_to_jax(sd: StateDict, prefix: str = "") -> dict:
    s = _sub(sd, prefix)
    return {"enc": res_stack_to_jax(s, "enc"), "proj": conv1x1_to_jax(s, "proj")}


def hifigan_generator_to_jax(sd: StateDict, prefix: str = "") -> dict:
    s = _sub(sd, prefix)
    params = {"conv_pre": wn_conv_to_jax(s, "conv_pre"), "conv_post": wn_conv_to_jax(s, "conv_post")}
    ups = _layer_indices(s, r"ups\.(\d+)\.")
    for i in ups:
        params[f"up_{i}"] = wn_conv_transpose1d_to_jax(s, f"ups.{i}")
    resblocks = _layer_indices(s, r"resblocks\.(\d+)\.")
    num_kernels = len(resblocks) // max(len(ups), 1)
    for r in resblocks:
        i, j = divmod(r, num_kernels)
        rs = _sub(s, f"resblocks.{r}")
        block = {}
        for m in _layer_indices(rs, r"convs1\.(\d+)\."):
            block[f"conv1_{m}"] = wn_conv_to_jax(rs, f"convs1.{m}")
        for m in _layer_indices(rs, r"convs2\.(\d+)\."):
            block[f"conv2_{m}"] = wn_conv_to_jax(rs, f"convs2.{m}")
        for m in _layer_indices(rs, r"convs\.(\d+)\."):
            block[f"conv_{m}"] = wn_conv_to_jax(rs, f"convs.{m}")
        params[f"resblock_{i}_{j}"] = block
    return params


def ms_generator_to_jax(sd: StateDict, prefix: str = "") -> dict:
    return {"generator": hifigan_generator_to_jax(_sub(sd, prefix), "generator")}


def generator_to_jax(sd: StateDict, prefix: str = "") -> dict:
    """Any decoder family (see ``generator_from_jax``)."""
    nested = any(k.startswith("generator.") for k in _sub(sd, prefix))
    return (ms_generator_to_jax if nested else hifigan_generator_to_jax)(sd, prefix)


def multi_stage_quantizer_to_jax(sd: StateDict, prefix: str = ""):
    """-> (params, codebook, batch_stats) trees of the JAX
    MultiStageQuantizer; ``batch_stats`` is {} without ``norm: True``."""
    s = _sub(sd, prefix)
    params, codebook, stats = {}, {}, {}
    for i in _layer_indices(s, r"quantizer\.(\d+)\."):
        q = _sub(s, f"quantizer.{i}")
        codebook[f"vq_{i}"] = {k: _np(q[k]) for k in ("embed", "cluster_size", "embed_avg")}
        params[f"pre_{i}_a"] = conv1x1_to_jax(s, f"preprocessor.{i}.0")
        params[f"pre_{i}_b"] = conv1x1_to_jax(s, f"preprocessor.{i}.2")
        params[f"post_{i}_a"] = dense_to_jax(s, f"postprocessor.{i}.0")
        params[f"post_{i}_b"] = dense_to_jax(s, f"postprocessor.{i}.2")
        if i > 0:
            params[f"prior_{i}"] = prior_predictor_to_jax(s, f"predictor.{i}")
        if any(k.startswith(f"transposed_conv.{i}.") for k in s):
            params[f"up_{i}"] = wn_conv_transpose1d_to_jax(s, f"transposed_conv.{i}")
        if f"preprocessor.{i}.3.running_mean" in s:
            stats[f"prenorm_{i}"] = {"mean": _np(s[f"preprocessor.{i}.3.running_mean"]),
                                     "var": _np(s[f"preprocessor.{i}.3.running_var"])}
    return params, codebook, stats


def msmc_vqgan_to_jax(sd: StateDict, prefix: str = "") -> dict:
    """Port MSMCVQGAN state_dict -> JAX variables {'params', 'codebook',
    'batch_stats'} (``batch_stats`` {} without ``norm: True``, as the JAX
    trainer leaves it)."""
    s = _sub(sd, prefix)
    q_params, q_codebook, q_stats = multi_stage_quantizer_to_jax(s, "quantizer")
    params = {
        "in_linear": dense_to_jax(s, "in_linear"),
        "quantizer": q_params,
        "decoder": generator_to_jax(s, "decoder"),
        "encoder": {
            f"encoder_{i}": fft_blocks_to_jax(s, f"encoder.encoders.{i}")
            for i in _layer_indices(s, r"encoder\.encoders\.(\d+)\.")
        },
    }
    if any(k.startswith("frame_decoder.") for k in s):
        params["frame_decoder"] = fft_blocks_to_jax(s, "frame_decoder")
    if any(k.startswith("mel_predictor.") for k in s):
        params["mel_predictor"] = dense_to_jax(s, "mel_predictor")
    return {"params": params, "codebook": {"quantizer": q_codebook},
            "batch_stats": {"quantizer": q_stats} if q_stats else {}}


def multi_stage_predictor_to_jax(sd: StateDict, prefix: str = "") -> dict:
    """Port MultiStagePredictor state_dict -> JAX params."""
    s = _sub(sd, prefix)
    d = _sub(s, "upsampler.duration_predictor")
    params = {
        "encoder": fft_blocks_to_jax(s, "encoder"),
        "upsampler": {
            "DurationPredictor_0": {
                "conv1": conv1d_to_jax(d, "conv1d_1"),
                "LayerNorm_0": layer_norm_to_jax(d, "layer_norm_1"),
                "conv2": conv1d_to_jax(d, "conv1d_2"),
                "LayerNorm_1": layer_norm_to_jax(d, "layer_norm_2"),
                "Dense_0": dense_to_jax(d, "linear_layer"),
            }
        },
    }
    if "word_emb.weight" in s:
        params["word_emb_0"] = {"embedding": _np(s["word_emb.weight"])}
    else:
        for i in _layer_indices(s, r"word_emb\.(\d+)\."):
            params[f"word_emb_{i}"] = {"embedding": _np(s[f"word_emb.{i}.weight"])}
    for i in _layer_indices(s, r"downsamplers\.(\d+)\."):
        params[f"downsampler_{i}"] = conv1d_to_jax(s, f"downsamplers.{i}")
    for i in _layer_indices(s, r"decoders\.(\d+)\."):
        params[f"dec_pre_{i}"] = dense_to_jax(s, f"decoders.{i}.0")
        params[f"dec_blocks_{i}"] = fft_blocks_to_jax(s, f"decoders.{i}.1")
        params[f"dec_out_{i}"] = dense_to_jax(s, f"decoders.{i}.2")
    return params


def discriminator_r_to_jax(sd: StateDict, prefix: str = "") -> dict:
    s = _sub(sd, prefix)
    return {
        f"conv_{i}": wn_conv_to_jax(s, f"discriminator.{i}.{1 if i == 0 else 2}")
        for i in _layer_indices(s, r"discriminator\.(\d+)\.")
    }


def discriminator_p_to_jax(sd: StateDict, prefix: str = "") -> dict:
    s = _sub(sd, prefix)
    params = {f"conv_{i}": wn_conv_to_jax(s, f"convs.{i}") for i in _layer_indices(s, r"convs\.(\d+)\.")}
    params["conv_post"] = wn_conv_to_jax(s, "conv_post")
    return params


def univnet_discriminator_to_jax(sd: StateDict, prefix: str = "", periods=(2, 3, 5, 7, 11)) -> dict:
    """Port UnivNetDiscriminator state_dict -> JAX params."""
    s = _sub(sd, prefix)
    mrd = {
        f"disc_{i}": discriminator_r_to_jax(s, f"mrd.discriminators.{i}")
        for i in _layer_indices(s, r"mrd\.discriminators\.(\d+)\.")
    }
    mpd = {f"disc_p{p}": discriminator_p_to_jax(s, f"mpd.discriminators.{i}") for i, p in enumerate(periods)}
    return {"mrd": mrd, "mpd": mpd}


def batch_norm_to_jax(sd: StateDict, prefix: str):
    """-> (params {scale, bias}, batch_stats {mean, var})."""
    s = _sub(sd, prefix)
    return ({"scale": _np(s["weight"]), "bias": _np(s["bias"])},
            {"mean": _np(s["running_mean"]), "var": _np(s["running_var"])})


def _conv_relu_bn_to_jax(sd: StateDict, prefix: str):
    bn_p, bn_s = batch_norm_to_jax(sd, f"{prefix}.bn")
    return {"Conv_0": conv1d_to_jax(sd, f"{prefix}.conv"), "BatchNorm_0": bn_p}, {"BatchNorm_0": bn_s}


def ecapa_tdnn_to_jax(sd: StateDict, prefix: str = ""):
    """Port ECAPA_TDNN state_dict -> (params, batch_stats) of the JAX module."""
    s = _sub(sd, prefix)
    params, stats = {}, {}
    params["layer1"], stats["layer1"] = _conv_relu_bn_to_jax(s, "layer1")
    for n in (2, 3, 4):
        base = f"layer{n}"
        p, st = {}, {}
        p["in"], st["in"] = _conv_relu_bn_to_jax(s, f"{base}.0")
        res2, res2_stats = {}, {}
        for i in _layer_indices(s, rf"{base}\.1\.convs\.(\d+)\."):
            res2[f"conv_{i}"] = conv1d_to_jax(s, f"{base}.1.convs.{i}")
            res2[f"bn_{i}"], res2_stats[f"bn_{i}"] = batch_norm_to_jax(s, f"{base}.1.bns.{i}")
        p["res2"], st["res2"] = res2, res2_stats
        p["out"], st["out"] = _conv_relu_bn_to_jax(s, f"{base}.2")
        p["se"] = {"Dense_0": dense_to_jax(s, f"{base}.3.linear1"), "Dense_1": dense_to_jax(s, f"{base}.3.linear2")}
        params[base], stats[base] = p, st
    params["conv"] = conv1x1_to_jax(s, "conv")
    params["pooling"] = {"Dense_0": conv1x1_to_jax(s, "pooling.linear1"),
                         "Dense_1": conv1x1_to_jax(s, "pooling.linear2")}
    params["bn1"], stats["bn1"] = batch_norm_to_jax(s, "bn1")
    params["linear"] = dense_to_jax(s, "linear")
    params["bn2"], stats["bn2"] = batch_norm_to_jax(s, "bn2")
    return params, stats


def attr_predictor_to_jax(sd: StateDict, prefix: str = "") -> dict:
    s = _sub(sd, prefix)
    return {"enc": res_stack_to_jax(s, "enc"), "proj": dense_to_jax(s, "proj")}


def emb_autoencoder_to_jax(sd: StateDict, prefix: str = "") -> dict:
    """Port state_dict of a QS-TTS network -> JAX variables {'params',
    'codebook', 'batch_stats'}."""
    s = _sub(sd, prefix)
    has = lambda p: any(k.startswith(p) for k in s)
    params = {"in_linear": dense_to_jax(s, "in_linear"), "decoder": hifigan_generator_to_jax(s, "decoder")}
    codebook, stats = {}, {}
    if has("encoder."):
        enc = {f"encoder_{i}": fft_blocks_to_jax(s, f"encoder.encoders.{i}")
               for i in _layer_indices(s, r"encoder\.encoders\.(\d+)\.")}
        if has("encoder.pitch_encoder."):
            enc["pitch_encoder"] = {f"c{j}": conv1d_to_jax(s, f"encoder.pitch_encoder.{2 * j}") for j in range(4)}
        params["encoder"] = enc
    if has("quantizer.quantizer."):
        params["quantizer"], codebook["quantizer"], q_stats = multi_stage_quantizer_to_jax(s, "quantizer")
        if q_stats:
            stats["quantizer"] = q_stats
    elif "quantizer.embed" in s:
        codebook["quantizer"] = {"embed": _np(s["quantizer.embed"])}
    if has("global_encoder."):
        params["global_encoder"], stats["global_encoder"] = ecapa_tdnn_to_jax(s, "global_encoder")
    if has("frame_decoder."):
        params["frame_decoder"] = fft_blocks_to_jax(s, "frame_decoder")
    if has("mel_predictor."):
        params["mel_predictor"] = dense_to_jax(s, "mel_predictor")
    return {"params": params, "codebook": codebook, "batch_stats": stats}


# ------------------------------------------------------------ train state


def train_state_from_jax(state: dict, autoencoder: nn.Module, discriminator: nn.Module):
    """Load a JAX VQGANTrainer state tree ({'params': {'autoencoder',
    'discriminator'}, 'codebook'}) into the port's two modules. Optimizer
    moments do not cross: they start fresh."""
    load_numpy_state(autoencoder, msmc_vqgan_from_jax(
        {"params": state["params"]["autoencoder"], "codebook": state["codebook"],
         "batch_stats": state.get("model_state", {}).get("batch_stats")}
    ))
    load_numpy_state(discriminator, univnet_discriminator_from_jax(
        state["params"]["discriminator"], periods=discriminator.mpd.periods
    ))


def train_state_to_jax(autoencoder: nn.Module, discriminator: nn.Module) -> dict:
    """The port's two modules -> a JAX VQGANTrainer state tree without
    optimizer state, the ``msmctts_tpu/v1`` checkpoint layout."""
    ae = msmc_vqgan_to_jax(state_dict_numpy(autoencoder))
    disc = univnet_discriminator_to_jax(state_dict_numpy(discriminator), periods=discriminator.mpd.periods)
    return {
        "params": {"autoencoder": ae["params"], "discriminator": disc},
        "codebook": ae["codebook"],
        "model_state": {"batch_stats": ae["batch_stats"]},
    }


# ------------------------------------------------------------ module I/O


def state_dict_numpy(module: nn.Module) -> StateDict:
    """The module's persistent state as float32 numpy arrays."""
    return {k: v.detach().cpu().float().numpy().copy() for k, v in module.state_dict().items()}


def load_numpy_state(module: nn.Module, sd: StateDict):
    """Load a numpy state_dict (strict: every key must match)."""
    module.load_state_dict({k: torch.tensor(_np(v)) for k, v in sd.items()}, strict=True)


@torch.no_grad()
def init_random(module: nn.Module, seed: int):
    """Seeded random init of every parameter and codebook (training from
    scratch, smoke and bench runs without trained weights): weights
    N(0, 1/fan_in), except N(0, 0.01) for the convs the JAX package draws so
    (``hifigan_init``); biases 0, LayerNorm scales 1, weight-norm scales =
    |v| (the kernel equals v), codebooks N(0, 1) with ``embed_avg`` = the
    codebook and ``cluster_size`` 0 (frozen k-means centroids and BN
    running statistics are left as built). Unlike flax's ``init``, which runs one
    training forward and so leaves one EMA update in the codebook, this takes
    no batch and makes no update."""
    gen = torch.Generator().manual_seed(seed)
    small = {
        f"{prefix}.weight_v" for prefix, m in module.named_modules() if getattr(m, "hifigan_init", False)
    }
    for name, p in module.named_parameters():
        if name.endswith("weight_g"):
            continue
        if p.dim() >= 2:
            std = 0.01 if name in small else p[0].numel() ** -0.5
            p.copy_(torch.randn(p.shape, generator=gen) * std)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    for name, p in module.named_parameters():
        if name.endswith("weight_g"):
            v = module.get_parameter(name[: -len("g")] + "v")
            p.copy_(torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True)))
    buffers = dict(module.named_buffers())
    for name, b in buffers.items():
        # an EMA codebook; a frozen one (k-means centroids, no embed_avg) keeps its values
        if name.endswith(".embed") and name[: -len("embed")] + "embed_avg" in buffers:
            b.copy_(torch.randn(b.shape, generator=gen))
            module.get_buffer(name[: -len("embed")] + "embed_avg").copy_(b)
            module.get_buffer(name[: -len("embed")] + "cluster_size").zero_()
    refold(module)


def assert_replicated(modules, group):
    """Raise unless every parameter and buffer of ``modules`` is bit-equal
    on all ranks of ``group`` (max over ranks of |x - x on rank 0| == 0).
    Every rank must call it: it communicates."""
    dev = max_deviation_from_rank0(list(modules), group)
    if dev != 0.0:
        raise AssertionError(f"state differs across ranks: max |x - x on rank 0| = {dev}")
