"""Multi-head nearest-codeword snap: kernel 1 of the port.

``vq_nearest(x [N, H, d], embed [H, d, K]) -> (idx [N, H] int32,
quant [N, H, d] fp32)``: per head, ``dist = |x|^2 - 2 x.E + |E|^2`` in fp32,
argmin with the first index winning ties, and the chosen codeword. It is
the function of ``msmctts_tpu/ops/pallas_vq.py::vq_nearest`` (Pallas
``_vq_snap_kernel``), and it carries every inference quantization of the
port: the predictor's per-stage snap and the synthesis re-quantization.

On a CUDA tensor the wrapper launches ``csrc/vq_nearest.cu`` or raises; on
a CPU tensor it runs :func:`vq_nearest_plain`, the same function in plain
PyTorch, which the CPU tests hold against JAX and ``chip_smoke.py`` holds
the kernel against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from msmctts_tpu_torch.ops.cuda_build import CudaKernel

WARPS = 8  # kWarps in csrc/vq_nearest.cu
MAX_SHARED_BYTES = 232448  # per block on sm_90

KERNEL = CudaKernel(
    "vq_nearest",
    "vq_nearest_launch",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int],
)


def shared_bytes(d: int, K: int) -> int:
    return (d * K + K + WARPS * d) * 4


def vq_nearest_plain(x: torch.Tensor, embed: torch.Tensor):
    """Plain PyTorch: explicit distance formula, argmin and gather."""
    x = x.float()
    embed = embed.float()
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)  # [N, H, 1]
    e_sq = torch.sum(embed * embed, dim=1)  # [H, K]
    xe = torch.einsum("nhd,hdk->nhk", x, embed)
    dist = x_sq - 2.0 * xe + e_sq
    idx = torch.argmin(dist, dim=-1)  # first minimum wins
    table = embed.transpose(1, 2)  # [H, K, d]
    heads = torch.arange(embed.shape[0], device=x.device)
    quant = table[heads[None, :], idx]  # [N, H, d]
    return idx.to(torch.int32), quant


def vq_nearest(x: torch.Tensor, embed: torch.Tensor):
    """x [N, H, d] (unit stride in d), embed [H, d, K] contiguous fp32 ->
    (idx [N, H] int32, quant [N, H, d] fp32)."""
    if x.device.type == "cpu":
        return vq_nearest_plain(x, embed)
    if x.device.type != "cuda":
        raise ValueError(f"vq_nearest: unsupported device {x.device}")
    if x.dim() != 3 or embed.dim() != 3:
        raise ValueError(f"vq_nearest: x {tuple(x.shape)} must be [N, H, d], embed {tuple(embed.shape)} [H, d, K]")
    N, H, d = x.shape
    if tuple(embed.shape[:2]) != (H, d):
        raise ValueError(f"vq_nearest: x {tuple(x.shape)} does not match embed {tuple(embed.shape)}")
    if x.dtype != torch.float32 or embed.dtype != torch.float32:
        raise TypeError(f"vq_nearest: needs float32, got {x.dtype} and {embed.dtype}")
    if embed.device != x.device or not embed.is_contiguous():
        raise ValueError("vq_nearest: embed must be a contiguous tensor on x's device")
    if x.stride(2) != 1:
        raise ValueError("vq_nearest: x needs unit stride in its last dimension")
    K = embed.shape[2]
    if shared_bytes(d, K) > MAX_SHARED_BYTES:
        raise ValueError(f"vq_nearest: codebook d={d}, K={K} does not fit in shared memory")
    idx = torch.empty((N, H), dtype=torch.int32, device=x.device)
    quant = torch.empty((N, H, d), dtype=torch.float32, device=x.device)
    KERNEL.launch(
        x.data_ptr(), x.stride(0), x.stride(1), embed.data_ptr(),
        idx.data_ptr(), quant.data_ptr(), N, H, d, K,
    )
    return idx, quant
