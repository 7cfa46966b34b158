"""Fused HiFi-GAN MRF dilation layer: row 5 of the kernel table (``PERF.md``).

``fused_resblock_layer(x [B, T, C], w1 [k, C, C], b1 [C], w2, b2, dilation)
= x + conv_k(lrelu(dconv_{k,d}(lrelu(x), w1, b1)), w2, b2)``, slope 0.1,
torch 'same' zero padding on both convs — the function of
``msmctts_tpu/ops/pallas_resblock.py::fused_resblock_layer``. Weights are
tap-major (tap, in, out), as the JAX package stores them.

On a CUDA tensor the wrapper launches ``csrc/resblock.cu`` or raises; on a
CPU tensor it runs :func:`fused_resblock_layer_plain`.

The kernel runs both convs on the tensor cores as 3xTF32 products: every
fp32 operand is split into a TF32 head and a TF32 tail (:func:`tf32_split`)
and ``a*b`` is taken as ``a_lo*b_hi + a_hi*b_lo + a_hi*b_hi`` with fp32
accumulation, which keeps fp32-class accuracy (the TPU kernel's
``Precision.HIGHEST`` is the same idea on the MXU).
:func:`fused_resblock_layer_split_plain` is that arithmetic in plain
PyTorch. The activations are split inside the kernel; the weights once, at
fold time, by :func:`prepare_taps`, into the buffer the kernel streams
through shared memory (``ResBlock1.fold`` keeps one per layer beside the
folded taps). :func:`plan_layer` is the single source of the kernel's tile
rows, ring depth and shared-memory bytes.

``msmctts::fused_resblock_layer`` is the layer as an operator
(``cuda_build.py``): the MRF layers of an exported program (``export.py``)
launch through it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from msmctts_tpu_torch.ops.cuda_build import CudaKernel, exporting

LRELU_SLOPE = 0.1
MAX_SHARED_BYTES = 232448  # per block on sm_90
SM_SHARED_BYTES = 233472  # per SM; every resident block also reserves 1 KB
BARRIER_BYTES = 128  # the ring's mbarriers, ahead of the ring
MAX_STAGES = 6
# Per width: rows per block (kM of csrc/resblock.cu), k8 slices per weight
# slab (kSlabSteps) and blocks per SM its registers are budgeted for.
BODIES = {256: (64, 1, 1), 128: (128, 2, 1), 64: (128, 4, 2), 32: (128, 4, 3)}

KERNEL = CudaKernel(
    "resblock",
    "resblock_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7,
)


class LayerPlan(NamedTuple):
    """What the launcher is told and the kernel asserts."""

    body: str  # the kernel body that runs this width
    tile: int  # rows of both convs computed per block (a multiple of 64)
    out_rows: int  # of which stored: tile - (k - 1)
    slab_bytes: int  # one stage of the weight ring
    stages: int  # ring depth
    shared_bytes: int  # dynamic shared memory per block


def shared_bytes(C: int, k: int, dilation: int, tile: int, stages: int = 2) -> int:
    """Barriers, ``stages`` weight slabs, and one fp32 plane of ``tile`` rows
    plus conv1's halo, padded to C + 4 floats a row (mid reuses it)."""
    slab = BODIES[C][1] * C * 64
    return BARRIER_BYTES + stages * slab + (tile + (k - 1) * dilation) * (C + 4) * 4


def plan_layer(C: int, k: int, dilation: int) -> LayerPlan:
    if C not in BODIES:
        raise ValueError(
            f"fused_resblock_layer: layer C={C}, k={k}, dilation={dilation} does not fit the kernel: "
            f"it has bodies for C in {sorted(BODIES)}"
        )
    tile, slab_steps, blocks = BODIES[C]
    slab = slab_steps * C * 64
    base = shared_bytes(C, k, dilation, tile, 0)
    # room for the width's blocks per SM if two stages fit in it, else the whole SM
    for limit in (SM_SHARED_BYTES // blocks - 1024, MAX_SHARED_BYTES):
        stages = min(MAX_STAGES, (limit - base) // slab)
        if stages >= 2 and k < tile:
            return LayerPlan("wgmma-3xtf32", tile, tile - (k - 1), slab, stages, base + stages * slab)
    raise ValueError(
        f"fused_resblock_layer: layer C={C}, k={k}, dilation={dilation} does not fit in shared memory "
        f"({base + 2 * slab} bytes at tile {tile}, limit {MAX_SHARED_BYTES})"
    )


def choose_tile(C: int, k: int, dilation: int) -> int:
    """Rows per block of the layer's plan."""
    return plan_layer(C, k, dilation).tile


def tf32_split(x: torch.Tensor):
    """fp32 -> (hi, lo), both exactly representable in TF32: ``hi`` is x
    rounded to its top 19 bits (sign, exponent, 10 mantissa bits; to nearest,
    ties away from zero, as ``cvt.rna.tf32.f32``), ``lo`` is ``x - hi``
    rounded the same way. ``hi + lo`` is within 2^-21 relative of x."""
    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def prepare_taps(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Both convs' taps [k, C_in, C_out] -> the kernel's weight stream, a
    flat fp32 buffer [conv, tap, C_in / 8, (hi, lo), C_out / 8, 2, 8, 4]:
    per k8 slice of C_in the TF32 heads of all C_out, then the tails, each
    as 8 x 4 "core matrices" (8 output channels by 4 input channels,
    contiguous) that ``wgmma`` reads from shared memory without swizzle."""
    k, C, _ = w1.shape
    parts = []
    for w in (w1, w2):
        split = torch.stack(tf32_split(w.float()))  # [2, k, ci, co]
        split = split.view(2, k, C // 8, 2, 4, C // 8, 8)  # [part, k, chunk, kc, kk, ng, nr]
        parts.append(split.permute(1, 2, 0, 5, 3, 6, 4))  # [k, chunk, part, ng, kc, nr, kk]
    return torch.stack(parts).contiguous().view(-1)


def taps_from_prepared(prepared: torch.Tensor, k: int, C: int):
    """The inverse of :func:`prepare_taps` up to the split's rounding:
    (w1, w2) as ``hi + lo``."""
    p = prepared.view(2, k, C // 8, 2, C // 8, 2, 8, 4).sum(dim=3)  # [conv, k, chunk, ng, kc, nr, kk]
    w = p.permute(0, 1, 2, 4, 6, 3, 5).reshape(2, k, C, C)
    return w[0], w[1]


def fused_resblock_layer_plain(x, w1, b1, w2, b2, dilation: int):
    """Plain PyTorch: two ``F.conv1d`` with dilation and padding, and lrelu.
    conv1's output covers exactly [0, T) and conv2 zero-pads it, which is
    the kernel's mid mask."""
    k = w1.shape[0]
    h = F.leaky_relu(x, LRELU_SLOPE).transpose(1, 2)
    h = F.conv1d(h, w1.permute(2, 1, 0), b1, padding=(k - 1) // 2 * dilation, dilation=dilation)
    h = F.leaky_relu(h, LRELU_SLOPE)
    h = F.conv1d(h, w2.permute(2, 1, 0), b2, padding=(k - 1) // 2)
    return x + h.transpose(1, 2)


def _conv_3xtf32(h, w, dilation: int):
    """conv1d of h [B, C, T] with taps w [k, C_in, C_out] as the kernel's
    three products, small terms first."""
    k = w.shape[0]
    h_hi, h_lo = tf32_split(h)
    w_hi, w_lo = (t.permute(2, 1, 0) for t in tf32_split(w))
    conv = lambda a, b: F.conv1d(a, b, padding=(k - 1) // 2 * dilation, dilation=dilation)
    return (conv(h_lo, w_hi) + conv(h_hi, w_lo)) + conv(h_hi, w_hi)


def fused_resblock_layer_split_plain(x, w1, b1, w2, b2, dilation: int):
    """Plain PyTorch emulation of the kernel's numerics: both convs as
    3xTF32 products of split operands (the ``a_lo*b_lo`` term is dropped),
    summed in fp32, then bias; otherwise :func:`fused_resblock_layer_plain`."""
    h = F.leaky_relu(x, LRELU_SLOPE).transpose(1, 2)
    h = _conv_3xtf32(h, w1, dilation) + b1[None, :, None]
    h = F.leaky_relu(h, LRELU_SLOPE)
    h = _conv_3xtf32(h, w2, 1) + b2[None, :, None]
    return x + h.transpose(1, 2)


def fused_resblock_layer(x, w1, b1, w2, b2, dilation: int, prepared: Optional[torch.Tensor] = None):
    """x [B, T, C]; w1/w2 [k, C, C] (tap, in, out); b1/b2 [C] -> [B, T, C].
    ``prepared`` is ``prepare_taps(w1, w2)`` when the caller keeps it (the
    kernel reads only that); without it the taps are prepared on each call."""
    if exporting():
        return torch.ops.msmctts.fused_resblock_layer(x, w1, b1, w2, b2, dilation, prepared)
    if x.device.type == "cpu":
        return fused_resblock_layer_plain(x, w1, b1, w2, b2, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock_layer: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"fused_resblock_layer: x {tuple(x.shape)} must be [B, T, C]")
    B, T, C = x.shape
    k = w1.shape[0]
    for name, t, shape in (("w1", w1, (k, C, C)), ("w2", w2, (k, C, C)), ("b1", b1, (C,)), ("b2", b2, (C,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_resblock_layer: {name} {tuple(t.shape)}, expected {shape}")
    if k % 2 == 0 or dilation < 1:
        raise ValueError(f"fused_resblock_layer: needs an odd kernel and dilation >= 1, got k={k}, d={dilation}")
    plan = plan_layer(C, k, dilation)
    if prepared is None:
        prepared = prepare_taps(w1, w2)
    if tuple(prepared.shape) != (4 * k * C * C,):
        raise ValueError(f"fused_resblock_layer: prepared taps {tuple(prepared.shape)}, expected ({4 * k * C * C},)")
    tensors = (x, prepared, b1, b2)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("fused_resblock_layer: needs float32 tensors")
    if any(t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError("fused_resblock_layer: needs contiguous tensors on one device")
    out = torch.empty_like(x)
    KERNEL.launch(
        x.data_ptr(), prepared.data_ptr(), b1.data_ptr(), b2.data_ptr(), out.data_ptr(),
        B, T, C, k, dilation, plan.tile, plan.stages,
    )
    return out


@torch.library.custom_op("msmctts::fused_resblock_layer", mutates_args=(), device_types="cpu")
def _fused_resblock_layer_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                             b2: torch.Tensor, dilation: int, prepared: Optional[torch.Tensor]) -> torch.Tensor:
    return fused_resblock_layer_plain(x, w1, b1, w2, b2, dilation)


@_fused_resblock_layer_op.register_kernel("cuda")
def _(x, w1, b1, w2, b2, dilation, prepared):
    return fused_resblock_layer(x, w1, b1, w2, b2, dilation, prepared)


@_fused_resblock_layer_op.register_fake
def _(x, w1, b1, w2, b2, dilation, prepared):
    return torch.empty_like(x)
