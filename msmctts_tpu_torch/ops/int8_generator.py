"""Int8 serving path of the HiFi-GAN generator (counterpart of
``msmctts_tpu/ops/int8_generator.py``).

A post-training-quantized twin of ``models/hifigan.HifiGANGenerator`` in
``eval()``:

* ``quantize_generator_params`` folds weight norm and quantizes every
  conv / transposed-conv kernel to int8 with per-output-channel symmetric
  scales (host numpy, once per checkpoint); ``float_sites`` keeps matching
  sites as folded float kernels, and ``conv_post`` always stays float.
* ``int8_generator_apply`` runs the generator's graph with every other conv
  as an s8 x s8 -> s32 product: activations are quantized per tensor
  (dynamic amax / 127, or static calibrated scales), accumulation is exact
  int32, then dequantization, bias and leaky ReLU in fp32.
* ``Int8Decoder`` calibrates on a first batch: per-site per-input-channel
  activation ranges, a SmoothQuant fold (arXiv:2211.10438) of those ranges
  into the per-output-channel kernels, and static per-tensor scales with
  ``headroom``.

The JAX package computes these convs with XLA's native int8 convolution,
outside any Pallas kernel, so here a library product computes them: on a
CUDA tensor ``int8_conv1d`` is one ``torch._int_mm`` (int8 operands, int32
accumulation, cuBLASLt) over an im2col of the padded input, its shape rules
met by zero padding; it never falls back to a float conv. The transposed conv is the
same product over the input dilated by the stride (zeros between samples)
with the taps flipped, under ``k - u == 2 p``. On a CPU tensor the plain
versions compute the same int32 sums exactly: one fp64 product per tap,
whose integer partial sums stay far below 2^53 (at most
k * C_in * 127^2 < 2^31 for every generator here).

``msmctts::int8_conv1d`` is the product as an operator (``cuda_build.py``):
the int8 decoder of an exported program (``export.py``) runs its products
through it, and so counts them on the card.

``Int8Decoder`` serves in the ``dtype`` it is built with, the task's compute
dtype as in the JAX package (``msmctts_tpu/tasks.py:379-386``): fp32 for the
shipped recipes, bf16 under ``precision: bfloat16``, where the dequantized
activations, the float sites and the ``tanh`` output are bf16 and the
int8 products and the fp32 ``conv_post`` are as in fp32. Its calibration
observes the activations through the graph in bf16 whatever it serves in,
as the JAX package's does. Inference only: no gradient is defined.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from msmctts_tpu_torch.ops.convs import fold_weight_norm
from msmctts_tpu_torch.ops.cuda_build import exporting

GEN_LRELU = 0.1

# products run by the int8 library path (``torch._int_mm`` on the card), as
# the kernels' ``launches`` count theirs
LAUNCHES = {"int8_conv1d": 0}


# ------------------------------------------------- fused_generator helpers
def _fold(conv, transposed: bool = False):
    """A weight-norm conv module -> (kernel f32 [k, in, out], bias or None),
    the JAX package's layout (``msmctts_tpu/ops/fused_generator.py:33-41``).
    A conv's ``weight_v`` is [out, in, k]; a transposed conv's [in, out, k]
    with its norm per input channel."""
    w = fold_weight_norm(conv.weight_v.detach().float(), conv.weight_g.detach().float())
    w = w.permute(2, 0, 1) if transposed else w.permute(2, 1, 0)
    return w.contiguous(), (None if conv.bias is None else conv.bias.detach().float())


def _conv1d(x, kernel, bias, stride: int = 1, padding: int = 0, dilation: int = 1):
    """[B, T, C_in] * [k, C_in, C_out] -> [B, T', C_out] (float)."""
    y = F.conv1d(x.transpose(1, 2), kernel.permute(2, 1, 0), bias, stride=stride, padding=padding,
                 dilation=dilation)
    return y.transpose(1, 2)


def _conv_transpose1d(x, kernel, bias, stride: int, padding: int):
    """torch-semantics transposed conv, [B, T, C_in] -> [B, T', C_out]."""
    y = F.conv_transpose1d(x.transpose(1, 2), kernel.permute(1, 2, 0), bias, stride=stride, padding=padding)
    return y.transpose(1, 2)


# --------------------------------------------------------------- weights
def _generator_sites(generator):
    """``site -> (module, transposed)`` in the JAX package's site names
    (``conv_pre``, ``up_{i}``, ``resblock_{i}_{j}/conv1_{m}`` and
    ``/conv2_{m}``, ``conv_post``) over a port ``HifiGANGenerator``."""
    sites = {"conv_pre": (generator.conv_pre, False)}
    nk = generator.num_kernels
    for i, up in enumerate(generator.ups):
        sites[f"up_{i}"] = (up, True)
        for j in range(nk):
            rb = generator.resblocks[i * nk + j]
            for m in range(len(rb.dilations)):
                sites[f"resblock_{i}_{j}/conv1_{m}"] = (rb.convs1[m], False)
                sites[f"resblock_{i}_{j}/conv2_{m}"] = (rb.convs2[m], False)
    sites["conv_post"] = (generator.conv_post, False)
    return sites


@torch.no_grad()
def _fold_generator_params(generator) -> dict:
    """Fold weight norm for every generator conv: a flat dict
    ``site -> (w f32 numpy [k, in, out], bias f32 numpy | None)``."""
    folded = {}
    for site, (conv, transposed) in _generator_sites(generator).items():
        w, b = _fold(conv, transposed)
        folded[site] = (w.cpu().numpy(), None if b is None else b.cpu().numpy())
    return folded


def _quantize_folded_kernel(w, b, s_in=None) -> dict:
    """Folded float kernel -> {w_q int8, scale f32 [out], bias, s_in?}
    (``int8_generator.py:75-99``): ``s_in`` (f32 [in]) is the SmoothQuant
    fold, multiplied into the kernel's input-channel axis."""
    if s_in is not None:
        shape = [1] * w.ndim
        shape[-2] = w.shape[-2]
        w = w * np.asarray(s_in, np.float32).reshape(shape)
    axes = tuple(range(w.ndim - 1))  # all but out-channel
    scale = np.max(np.abs(w), axis=axes) / 127.0
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    w_q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    node = {"w_q": w_q, "scale": scale}
    if b is not None:
        node["bias"] = b
    if s_in is not None:
        node["s_in"] = np.asarray(s_in, np.float32)
    return node


def _is_float_site(site: str, float_sites) -> bool:
    return any(site == p or site.startswith(p) for p in float_sites)


def _quantize_folded(folded: dict, decoder_config: dict, smooth=None, float_sites=()) -> dict:
    """Flat folded dict -> the nested qparams ``int8_generator_apply``
    takes: ``{"conv_pre", "up_{i}", "resblock_{i}_{j}": {"conv1_{m}", ...},
    "conv_post"}``; a ``float_sites`` match and ``conv_post`` keep
    ``{"w", "bias"}``."""
    smooth = smooth or {}

    def q(site):
        w, b = folded[site]
        if _is_float_site(site, float_sites):
            return {"w": w, "bias": b}
        return _quantize_folded_kernel(w, b, smooth.get(site))

    out = {"conv_pre": q("conv_pre")}
    for i in range(len(decoder_config["upsample_rates"])):
        out[f"up_{i}"] = q(f"up_{i}")
        for j in range(len(decoder_config["resblock_kernel_sizes"])):
            prefix = f"resblock_{i}_{j}/"
            out[f"resblock_{i}_{j}"] = {site[len(prefix):]: q(site) for site in folded if site.startswith(prefix)}
    w, b = folded["conv_post"]
    out["conv_post"] = {"w": w, "bias": b}
    return out


def quantize_generator_params(generator, decoder_config: dict, smooth=None, float_sites=()) -> dict:
    """Quantize a trained ``HifiGANGenerator`` (the port's module) for int8
    serving: numpy leaves, int8 kernels with f32 scales and biases."""
    return _quantize_folded(_fold_generator_params(generator), decoder_config, smooth, float_sites)


def build_smoothing(folded: dict, act_amax: dict, alpha: float) -> dict:
    """SmoothQuant vectors ``s_c = a_c^alpha / w_c^(1-alpha)`` per input
    channel, geometric-mean normalized (``int8_generator.py:150-174``)."""
    smooth = {}
    for site, a_c in act_amax.items():
        if site == "conv_post" or site not in folded:
            continue
        w, _ = folded[site]
        w_c = np.max(np.abs(w), axis=(0,) + tuple(range(2, w.ndim)))  # per input channel
        a_c = np.maximum(np.asarray(a_c, np.float32), 1e-5)
        s = (a_c ** alpha) / (np.maximum(w_c, 1e-5) ** (1.0 - alpha))
        s = s / np.exp(np.mean(np.log(np.maximum(s, 1e-8))))
        smooth[site] = np.maximum(s, 1e-3).astype(np.float32)
    return smooth


# ------------------------------------------------------------ int8 compute
def _taps(xq, k: int, padding: int, dilation: int):
    """Zero-padded input and the output length of a stride-1 conv."""
    xp = F.pad(xq, (0, 0, padding, padding))
    return xp, xp.shape[1] - dilation * (k - 1)


def int8_conv1d_plain(xq, w_q, padding: int, dilation: int = 1):
    """The int32 sums of ``int8_conv1d`` on any device: one fp64 product per
    tap, exact for int8 operands (every partial sum is an integer far below
    2^53). xq [B, T, C_in] int8, w_q [k, C_in, C_out] int8 -> int32."""
    k = w_q.shape[0]
    xp, t_out = _taps(xq.double(), k, padding, dilation)
    w = w_q.double()
    acc = None
    for j in range(k):
        y = torch.matmul(xp[:, j * dilation: j * dilation + t_out], w[j])
        acc = y if acc is None else acc + y
    return acc.to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _int8_conv1d_im2col(xq, w_q, padding: int, dilation: int):
    """The card's formulation: the batch's zero-padded rows laid end to end
    in one [rows, C_in] buffer, whose im2col is a strided view (row r, tap j
    at row r + j * dilation) copied once into [rows, k * C_in], then one
    ``torch._int_mm`` against the [k * C_in, C_out] taps. Rows that straddle
    two utterances are computed and never read. The buffer's rows are a
    multiple of 32 and the inner and output widths multiples of 8 (zero
    padding, which adds nothing to the sums), so that cuBLASLt's int8 product
    takes every shape; more than 16 rows, as ``torch._int_mm`` asks."""
    k, c_in, c_out = w_q.shape
    B, T, _ = xq.shape
    tp = T + 2 * padding
    t_out = tp - dilation * (k - 1)
    rows = _round_up(max(B * tp - dilation * (k - 1), 17), 32)
    k_p, n_p = _round_up(k * c_in, 8), _round_up(c_out, 8)
    flat = xq.new_zeros((rows + dilation * (k - 1), c_in))
    flat[: B * tp].view(B, tp, c_in)[:, padding: padding + T] = xq
    # a copy: at dilation 1 the strided rows overlap and reshape would keep a view
    cols = flat.as_strided((rows, k, c_in), (c_in, dilation * c_in, 1)).contiguous().view(rows, k * c_in)
    w = w_q.reshape(k * c_in, c_out)
    if k_p != k * c_in:
        cols = F.pad(cols, (0, k_p - k * c_in))
    if (k_p, n_p) != (k * c_in, c_out):
        w = F.pad(w, (0, n_p - c_out, 0, k_p - k * c_in))
    y = torch._int_mm(cols, w.contiguous())  # [rows, n_p] int32
    LAUNCHES["int8_conv1d"] += 1
    # utterance b's output row t is buffer row b * tp + t
    return y.as_strided((B, t_out, c_out), (tp * n_p, n_p, 1))


def int8_conv1d(xq, w_q, padding: int, dilation: int = 1):
    """1-D s8 x s8 -> s32 conv (``int8_generator.py:188-206``). xq
    [B, T, C_in] int8, w_q [k, C_in, C_out] int8 -> [B, T', C_out] int32.
    On a CUDA tensor: one ``torch._int_mm`` over an im2col of the input
    (``_int8_conv1d_im2col``); on a CPU tensor: ``int8_conv1d_plain``."""
    if xq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_conv1d takes int8 operands, got {xq.dtype} and {w_q.dtype}")
    if exporting():
        return torch.ops.msmctts.int8_conv1d(xq, w_q, padding, dilation)
    if not xq.is_cuda:
        return int8_conv1d_plain(xq, w_q, padding, dilation)
    return _int8_conv1d_im2col(xq, w_q, padding, dilation)


@torch.library.custom_op("msmctts::int8_conv1d", mutates_args=(), device_types="cpu")
def _int8_conv1d_op(xq: torch.Tensor, w_q: torch.Tensor, padding: int, dilation: int) -> torch.Tensor:
    return int8_conv1d_plain(xq, w_q, padding, dilation)


@_int8_conv1d_op.register_kernel("cuda")
def _(xq, w_q, padding, dilation):
    return _int8_conv1d_im2col(xq, w_q, padding, dilation)


@_int8_conv1d_op.register_fake
def _(xq, w_q, padding, dilation):
    k, _, c_out = w_q.shape
    B, T, _ = xq.shape
    return xq.new_empty((B, T + 2 * padding - dilation * (k - 1), c_out), dtype=torch.int32)


def _dilate(xq, stride: int):
    """[B, T, C] -> [B, (T - 1) * stride + 1, C] with zeros between samples."""
    if stride == 1:
        return xq
    B, T, C = xq.shape
    out = torch.zeros((B, (T - 1) * stride + 1, C), dtype=xq.dtype, device=xq.device)
    out[:, ::stride] = xq
    return out


def int8_conv_transpose1d(xq, w_q, stride: int, padding: int):
    """torch-semantics transposed conv in int8 (``int8_generator.py:209-229``):
    a correlation of the input dilated by ``stride`` with the flipped taps,
    padded by k - 1 - p. Requires k - stride == 2 * padding, so that the
    output has exactly T * stride samples."""
    k = w_q.shape[0]
    if k - stride != 2 * padding:
        raise ValueError(f"int8_conv_transpose1d needs k - stride == 2 * padding, got k={k}, "
                         f"stride={stride}, padding={padding}")
    return int8_conv1d(_dilate(xq, stride), torch.flip(w_q, dims=(0,)), k - 1 - padding, 1)


def static_scale(scale: float, device) -> tuple:
    """A static scale (python float) as the fp32 pair (s, 1 / s) on
    ``device``, the reciprocal rounded to fp32 once."""
    s = np.float32(scale)
    return (torch.tensor(s, device=device), torch.tensor(np.float32(1.0) / s, device=device))


class _ActQuant:
    """Per-site activation quantizer (``int8_generator.py:232-273``): dynamic
    per-tensor amax (default), static scales (``scales``: site -> python
    float, or its ``static_scale`` pair on the device) or observation
    (``observe`` collects per-site per-input-channel amax).

    A static scale is the fp32 ``jnp.float32(scale)``, and x is multiplied by
    its fp32 reciprocal rather than divided by it: the JAX package's serving
    graphs are jitted with the scale as a constant, and XLA folds a division
    by a constant into that multiplication. A dynamic scale is a value of
    the graph, by which XLA divides, and so does this."""

    def __init__(self, scales=None, observe=None):
        self.scales = scales
        self.observe = observe

    def __call__(self, x, site: str, s_in=None):
        xf = x.float()
        if s_in is not None:
            xf = xf / s_in  # SmoothQuant: the kernel carries the matching multiply
        if self.scales is not None:
            v = self.scales[site]
            s, inv = v if isinstance(v, tuple) else static_scale(v, xf.device)
            scaled = xf * inv
        else:
            amax_c = torch.amax(torch.abs(xf), dim=tuple(range(xf.dim() - 1)))
            if self.observe is not None:
                self.observe[site] = amax_c
            s = torch.clamp(torch.max(amax_c), min=1e-8) / 127.0
            scaled = xf / s
        q = torch.clamp(torch.round(scaled), -127.0, 127.0).to(torch.int8)
        return q, s


def _dequant(y_i32, s_x, node, dtype=torch.float32):
    """int32 sums -> ``dtype``: ``y * (s_x * scale) + bias`` in fp32, the
    scale product first, as ``int8_generator.py:268-272`` takes it."""
    y = y_i32.float() * (s_x * node["scale"])
    if node.get("bias") is not None:
        y = y + node["bias"]
    return y.to(dtype)


def _lrelu(x, slope: float = GEN_LRELU):
    if x.dtype == torch.float32:
        return F.leaky_relu(x, slope)  # x * fp32(slope) below 0: JAX's value, in one kernel
    # the slope in x's dtype, as a python float meets a bf16 array in JAX
    return torch.where(x >= 0, x, torch.tensor(slope, dtype=x.dtype, device=x.device) * x)


def _site_conv(node, x, padding: int, dilation: int, dtype, aq, site: str):
    """One conv site: quantize, int8 conv, dequantize; or the float kernel of
    a ``float_sites`` node, in ``dtype``."""
    if "w" in node:
        bias = None if node["bias"] is None else node["bias"].to(dtype)
        return _conv1d(x.to(dtype), node["w"].to(dtype), bias, padding=padding, dilation=dilation)
    q, s = aq(x, site, node.get("s_in"))
    return _dequant(int8_conv1d(q, node["w_q"], padding, dilation), s, node, dtype)


def _resblock_i8(qp, x, kernel_size: int, dilations, dtype, aq, site: str):
    for i, d in enumerate(dilations):
        h = _site_conv(qp[f"conv1_{i}"], _lrelu(x), (kernel_size - 1) // 2 * d, d, dtype, aq, f"{site}/conv1_{i}")
        h = _site_conv(qp[f"conv2_{i}"], _lrelu(h), (kernel_size - 1) // 2, 1, dtype, aq, f"{site}/conv2_{i}")
        x = x + h
    return x


def qparams_to(qparams: dict, device) -> dict:
    """The qparams tree with every array leaf a tensor on ``device``."""
    out = {}
    for k, v in qparams.items():
        if isinstance(v, dict):
            out[k] = qparams_to(v, device)
        else:
            out[k] = None if v is None else torch.as_tensor(v).to(device)
    return out


@torch.inference_mode()
def int8_generator_apply(qparams, x, decoder_config, act_scales=None, dtype=torch.float32, _observe=None):
    """The quantized twin of ``HifiGANGenerator`` (``int8_generator.py:290-345``):
    x [B, T, num_mels] -> [B, T * prod(upsample_rates), 1] in ``dtype``.
    ``qparams`` is ``quantize_generator_params``'s tree with tensor leaves
    on x's device (``qparams_to``; ``Int8Decoder`` keeps such a copy);
    ``act_scales`` (site -> float or ``static_scale`` pair) switches from
    dynamic to static activation scales. Between the convs the activations are held in ``dtype``: fp32
    when serving; calibration observes through the bf16 graph, as the JAX
    package's does (its ``_observe_act_amax`` runs this function at its
    default dtype, bf16)."""
    rates = list(decoder_config["upsample_rates"])
    uks = list(decoder_config["upsample_kernel_sizes"])
    rks = list(decoder_config["resblock_kernel_sizes"])
    rds = [list(d) for d in decoder_config["resblock_dilation_sizes"]]
    aq = _ActQuant(scales=act_scales, observe=_observe)

    x = _site_conv(qparams["conv_pre"], x, 3, 1, dtype, aq, "conv_pre")
    for i, (u, k) in enumerate(zip(rates, uks)):
        x = _lrelu(x)
        node = qparams[f"up_{i}"]
        if "w" in node:
            bias = None if node["bias"] is None else node["bias"].to(dtype)
            x = _conv_transpose1d(x.to(dtype), node["w"].to(dtype), bias, u, (k - u) // 2)
        else:
            q, s = aq(x, f"up_{i}", node.get("s_in"))
            x = _dequant(int8_conv_transpose1d(q, node["w_q"], u, (k - u) // 2), s, node, dtype)
        acc = None
        for j, rk in enumerate(rks):
            r = _resblock_i8(qparams[f"resblock_{i}_{j}"], x, rk, rds[j], dtype, aq, f"resblock_{i}_{j}")
            acc = r if acc is None else acc + r
        x = acc / len(rks)
    # final activation: torch's default slope 0.01 (reference generator.py:52)
    x = _lrelu(x, 0.01)
    node = qparams["conv_post"]
    return torch.tanh(_conv1d(x.float(), node["w"], node["bias"], padding=3)).to(dtype)


class Int8Decoder:
    """Serving wrapper (``int8_generator.py:348-421``): quantized kernels and
    lazily calibrated static scales over a trained port ``HifiGANGenerator``.

    ``calibrate(feats)`` observes per-site per-input-channel amax on the
    decoder inputs (the first batch), applies the SmoothQuant fold
    (``smooth_alpha``; None disables it) and freezes per-tensor scales with
    ``headroom``; ``apply(feats)`` then runs the static-scale graph with its
    activations in ``dtype``. ``qparams`` and ``scales`` keep numpy leaves
    and python floats, as the JAX package's do; their copies on the
    features' device are made once after each calibration."""

    def __init__(self, generator, decoder_config, headroom: float = 1.1, dtype: torch.dtype = torch.float32,
                 smooth_alpha: Optional[float] = 1.0, float_sites=()):
        self.decoder_config = {k: (list(v) if isinstance(v, (list, tuple)) else v)
                               for k, v in dict(decoder_config).items()}
        self._folded = _fold_generator_params(generator)
        self.float_sites = tuple(float_sites)
        # unsmoothed quantization: what calibrate() observes through (it must
        # see the raw activation ranges) and what serves until it has run
        self._qparams_base = _quantize_folded(self._folded, self.decoder_config, float_sites=self.float_sites)
        self.qparams = self._qparams_base
        self.headroom = float(headroom)
        self.dtype = dtype
        self.smooth_alpha = smooth_alpha
        self.scales: Optional[dict] = None
        self._device = {}  # copies on a device: (what, device) -> tree

    def _on(self, what: str, device) -> dict:
        key = (what, str(device))
        cached = self._device.get(key)
        if cached is None:
            if what == "scales":
                cached = {k: static_scale(v, device) for k, v in self.scales.items()}
            else:
                cached = qparams_to(getattr(self, what), device)
            self._device[key] = cached
        return cached

    def calibrate(self, feats) -> None:
        amax = _observe_act_amax(self._on("_qparams_base", feats.device), [feats], self.decoder_config)
        if self.smooth_alpha is not None:
            smooth = build_smoothing(self._folded, amax, self.smooth_alpha)
            self.qparams = _quantize_folded(self._folded, self.decoder_config, smooth, float_sites=self.float_sites)
            # post-fold per-tensor amax is exactly max_c(a_c / s_c)
            amax = {site: a / smooth[site] if site in smooth else a for site, a in amax.items()}
        self.scales = _scales_from_amax(amax, self.headroom)
        self._device = {k: v for k, v in self._device.items() if k[0] == "_qparams_base"}

    def apply(self, feats):
        """[B, T, C] decoder inputs -> [B, T * ratio, 1]; ``calibrate`` must
        run first."""
        if self.scales is None:
            raise RuntimeError("Int8Decoder.calibrate(feats) must run first")
        return int8_generator_apply(self._on("qparams", feats.device), feats, self.decoder_config,
                                    act_scales=self._on("scales", feats.device), dtype=self.dtype)


def _observe_act_amax(qparams, batches, decoder_config) -> dict:
    """Per-site per-input-channel |max| (numpy f32 [C_in]) over the dynamic
    graph in bf16 (as ``int8_generator.py:424-444`` observes), max-merged
    over batches."""
    merged: dict = {}
    for x in batches:
        obs: dict = {}
        int8_generator_apply(qparams, x, decoder_config, dtype=torch.bfloat16, _observe=obs)
        for site, amax_c in obs.items():
            amax_c = amax_c.cpu().numpy().astype(np.float32)
            prev = merged.get(site)
            merged[site] = amax_c if prev is None else np.maximum(prev, amax_c)
    return merged


def _scales_from_amax(amax: dict, headroom: float) -> dict:
    """Static per-tensor scales (python floats): each site's largest |x|,
    times ``headroom``, over 127."""
    return {site: max(float(np.max(a)) * headroom, 1e-8) / 127.0 for site, a in amax.items()}


def calibrate_act_scales(qparams, batches, decoder_config, headroom: float = 1.0) -> dict:
    """Static per-site per-tensor scales: the max over batches of each
    site's amax, times ``headroom``, over 127 (``qparams`` on the batches'
    device)."""
    return _scales_from_amax(_observe_act_amax(qparams, batches, decoder_config), headroom)
