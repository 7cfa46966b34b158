"""Fused HiFi-GAN MRF dilation layer: kernel 2 of the port.

``fused_resblock_layer(x [B, T, C], w1 [k, C, C], b1 [C], w2, b2, dilation)
= x + conv_k(lrelu(dconv_{k,d}(lrelu(x), w1, b1)), w2, b2)``, slope 0.1,
torch 'same' zero padding on both convs — the function of
``msmctts_tpu/ops/pallas_resblock.py::fused_resblock_layer``. Weights are
tap-major (tap, in, out), as the JAX package stores them.

On a CUDA tensor the wrapper launches ``csrc/resblock.cu`` or raises; on a
CPU tensor it runs :func:`fused_resblock_layer_plain`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from msmctts_tpu_torch.ops.cuda_build import CudaKernel

LRELU_SLOPE = 0.1
MAX_SHARED_BYTES = 232448  # per block on sm_90
# Largest shared footprint that still lets two blocks share an SM.
TWO_BLOCK_BYTES = 110 * 1024
TILES = (256, 128, 64, 32)

KERNEL = CudaKernel(
    "resblock",
    "resblock_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6,
)


def shared_bytes(C: int, k: int, dilation: int, tile: int) -> int:
    h2 = (k - 1) // 2
    ha = h2 * dilation + h2
    return ((tile + 2 * ha) + (tile + 2 * h2)) * (C + 1) * 4


def choose_tile(C: int, k: int, dilation: int) -> int:
    """Largest time tile whose x and mid buffers let two blocks share an
    SM; failing that, the largest that fits one block."""
    for limit in (TWO_BLOCK_BYTES, MAX_SHARED_BYTES):
        for tile in TILES:
            if shared_bytes(C, k, dilation, tile) <= limit:
                return tile
    raise ValueError(
        f"fused_resblock_layer: C={C}, k={k}, dilation={dilation} does not fit in shared memory"
    )


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


def fused_resblock_layer(x, w1, b1, w2, b2, dilation: int):
    """x [B, T, C]; w1/w2 [k, C, C] (tap, in, out); b1/b2 [C] -> [B, T, C]."""
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
    tensors = (x, w1, b1, w2, b2)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("fused_resblock_layer: needs float32 tensors")
    if any(t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError("fused_resblock_layer: needs contiguous tensors on one device")
    if k % 2 == 0 or dilation < 1:
        raise ValueError(f"fused_resblock_layer: needs an odd kernel and dilation >= 1, got k={k}, d={dilation}")
    if C % 4 or C > 1024:
        raise ValueError(f"fused_resblock_layer: C={C} must be a multiple of 4 and at most 1024")
    tile = choose_tile(C, k, dilation)
    out = torch.empty_like(x)
    KERNEL.launch(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), B, T, C, k, dilation, tile,
    )
    return out
