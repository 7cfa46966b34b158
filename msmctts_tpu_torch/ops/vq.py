"""Multi-head nearest-codeword search: the snap (kernel 1 of the port) and
the snap with masked EMA statistics (kernel 3, the training path).

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

``vq_nearest_stats(x, embed, mask [N]) -> (idx, quant, counts [H, K],
sums [H, d, K])`` adds, per head, ``counts[k] = sum_n mask[n] [idx[n] == k]``
and ``sums[:, k] = sum_n mask[n] x[n] [idx[n] == k]`` in fp32: the function
of ``msmctts_tpu/ops/pallas_vq.py::vq_nearest_stats`` (Pallas ``_vq_kernel``),
which feeds the codebook EMA of the autoencoder's train step. On a CUDA
tensor it launches ``csrc/vq_stats.cu`` (a fixed reduction order: the same
inputs give bit-equal statistics on every launch; idx and quant are
bit-equal to ``vq_nearest``'s) or raises; on a CPU tensor it runs
:func:`vq_nearest_stats_plain`. Neither function is differentiable: callers
detach the inputs and rebuild the straight-through estimator outside.
"""

from __future__ import annotations

import ctypes

import torch

from msmctts_tpu_torch.ops.cuda_build import CudaKernel

WARPS = 8  # kWarps in csrc/vq_common.cuh
ROWS_PER_TILE = 64  # kRowsPerBlock in csrc/vq_common.cuh
MAX_WALKERS = 32  # blocks per head that walk the row tiles of vq_stats
MAX_SHARED_BYTES = 232448  # per block on sm_90

KERNEL = CudaKernel(
    "vq_nearest",
    "vq_nearest_launch",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int],
)
STATS_KERNEL = CudaKernel(
    "vq_stats",
    "vq_stats_launch",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int],
)


def shared_bytes(d: int, K: int) -> int:
    return (d * K + K + WARPS * d) * 4


def stats_shared_bytes(d: int, K: int) -> int:
    return (2 * (d * K + K) + ROWS_PER_TILE * d + 2 * ROWS_PER_TILE) * 4


def stats_walkers(N: int) -> int:
    """Blocks per head of ``vq_stats``: a function of N alone, so that the
    order of the reduction, and with it every bit of the statistics, is
    fixed by the shapes."""
    return max(1, min(MAX_WALKERS, -(-N // ROWS_PER_TILE)))


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


def vq_nearest_stats_plain(x: torch.Tensor, embed: torch.Tensor, mask: torch.Tensor):
    """Plain PyTorch: :func:`vq_nearest_plain`, then the masked one-hot sums
    of the unfused formula (``msmctts_tpu/models/quantizer.py:172-182``)."""
    idx, quant = vq_nearest_plain(x, embed)
    K = embed.shape[2]
    m = mask.float()
    onehot = torch.nn.functional.one_hot(idx.long(), K).float() * m[:, None, None]  # [N, H, K]
    counts = onehot.sum(dim=0)  # [H, K]
    sums = torch.einsum("nhd,nhk->hdk", x.float() * m[:, None, None], onehot)
    return idx, quant, counts, sums


def _check_cuda_inputs(name: str, x: torch.Tensor, embed: torch.Tensor, smem_bytes):
    """The checks both kernels share; returns (N, H, d, K)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 3 or embed.dim() != 3:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be [N, H, d], embed {tuple(embed.shape)} [H, d, K]")
    N, H, d = x.shape
    if tuple(embed.shape[:2]) != (H, d):
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match embed {tuple(embed.shape)}")
    if x.dtype != torch.float32 or embed.dtype != torch.float32:
        raise TypeError(f"{name}: needs float32, got {x.dtype} and {embed.dtype}")
    if embed.device != x.device or not embed.is_contiguous():
        raise ValueError(f"{name}: embed must be a contiguous tensor on x's device")
    if x.stride(2) != 1:
        raise ValueError(f"{name}: x needs unit stride in its last dimension")
    K = embed.shape[2]
    if smem_bytes(d, K) > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: codebook d={d}, K={K} does not fit in shared memory")
    return N, H, d, K


def vq_nearest(x: torch.Tensor, embed: torch.Tensor):
    """x [N, H, d] (unit stride in d), embed [H, d, K] contiguous fp32 ->
    (idx [N, H] int32, quant [N, H, d] fp32)."""
    if x.device.type == "cpu":
        return vq_nearest_plain(x, embed)
    N, H, d, K = _check_cuda_inputs("vq_nearest", x, embed, shared_bytes)
    idx = torch.empty((N, H), dtype=torch.int32, device=x.device)
    quant = torch.empty((N, H, d), dtype=torch.float32, device=x.device)
    KERNEL.launch(
        x.data_ptr(), x.stride(0), x.stride(1), embed.data_ptr(),
        idx.data_ptr(), quant.data_ptr(), N, H, d, K,
    )
    return idx, quant


def vq_nearest_stats(x: torch.Tensor, embed: torch.Tensor, mask: torch.Tensor):
    """x [N, H, d] (unit stride in d), embed [H, d, K] contiguous fp32,
    mask [N] fp32 row weights (1 = a valid frame) -> (idx [N, H] int32,
    quant [N, H, d], counts [H, K], sums [H, d, K]), all fp32. Rows with
    mask 0 still get idx and quant; only the statistics leave them out."""
    if x.device.type == "cpu":
        return vq_nearest_stats_plain(x, embed, mask)
    N, H, d, K = _check_cuda_inputs("vq_nearest_stats", x, embed, stats_shared_bytes)
    if mask.dtype != torch.float32 or tuple(mask.shape) != (N,):
        raise ValueError(f"vq_nearest_stats: mask must be float32 [{N}], got {mask.dtype} {tuple(mask.shape)}")
    if mask.device != x.device or not mask.is_contiguous():
        raise ValueError("vq_nearest_stats: mask must be a contiguous tensor on x's device")
    idx = torch.empty((N, H), dtype=torch.int32, device=x.device)
    quant = torch.empty((N, H, d), dtype=torch.float32, device=x.device)
    G = stats_walkers(N)
    part = torch.empty((G, H, K + d * K), dtype=torch.float32, device=x.device)
    # zeros: with no rows the launcher returns without writing
    counts = torch.zeros((H, K), dtype=torch.float32, device=x.device)
    sums = torch.zeros((H, d, K), dtype=torch.float32, device=x.device)
    STATS_KERNEL.launch(
        x.data_ptr(), x.stride(0), x.stride(1), embed.data_ptr(), mask.data_ptr(),
        idx.data_ptr(), quant.data_ptr(), part.data_ptr(), counts.data_ptr(), sums.data_ptr(),
        N, H, d, K, G,
    )
    return idx, quant, counts, sums
