"""Multi-head nearest-codeword search: the snap (rows 1 and 4 of the kernel
table in ``PERF.md``) and the snap with masked EMA statistics (rows 2 and 3,
the training path).

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
:func:`vq_nearest_stats_plain`. :func:`stats_plan` is the single source of
the kernel's grid (walkers per head), its shared bytes and the layout of
its statistics pass. Neither function is differentiable: callers
detach the inputs and rebuild the straight-through estimator outside.

Under data parallelism (``parallel/mesh.py``) every rank holds a block of
the rows and a replica of the codebook. ``vq_nearest_stats_sharded(x_local,
embed, mask_local, group)`` is the statistics kernel on the rank's rows
followed by one ``all_reduce(SUM)`` of counts and sums, which the kernel
writes into one flat buffer: the function of
``msmctts_tpu/ops/pallas_vq.py::vq_nearest_stats_sharded``, whose partition
rule ``psum``s the two over the row axes. The returned statistics are the
global ones, bit-equal on every rank. ``vq_nearest_sharded(x_local, embed)``
is the snap kernel on the rank's rows and runs no collective
(``pallas_vq.py::vq_nearest_sharded``). Each has its plain version beside it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from msmctts_tpu_torch.ops.cuda_build import CudaKernel
from msmctts_tpu_torch.parallel.mesh import all_reduce_sum

WARPS = 8  # kWarps in csrc/vq_common.cuh
ROWS_PER_TILE = 64  # kRowsPerBlock in csrc/vq_common.cuh
GROUP = 8  # kGroup in csrc/vq_common.cuh: rows a warp searches at once
# Blocks per head that walk the row tiles of vq_stats: 64 x 4 heads fill the
# H100's 132 SMs at two blocks each (kBlocksPerSM of csrc/vq_stats.cu) in one wave.
MAX_WALKERS = 64
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


def _codebook_floats(d: int, K: int) -> int:
    """The staged codebook [d][K], its transpose [K][et_stride(d)] and |E|^2 [K]."""
    return d * K + K * ((d + 3) // 4 * 4 + 4) + K


def shared_bytes(d: int, K: int) -> int:
    return (_codebook_floats(d, K) + WARPS * GROUP * d + WARPS * GROUP) * 4


def acc_stride(K: int) -> int:
    """Row stride of the sums accumulators [d][acc_stride] (``acc_stride``
    of csrc/vq_stats.cu): odd, so that 32 consecutive j at one k lie in 32
    shared-memory banks."""
    return K | 1


def stats_shared_bytes(d: int, K: int) -> int:
    """The codebook, the tile's rows, the accumulators (sums [d][K | 1],
    counts [K]), row weights and codes, and one row list per warp."""
    tile = ROWS_PER_TILE
    return (_codebook_floats(d, K) + tile * d + d * acc_stride(K) + K + 2 * tile + WARPS * tile) * 4


def stats_walkers(N: int) -> int:
    """Blocks per head of ``vq_stats``: a function of N alone, so that the
    order of the reduction, and with it every bit of the statistics, is
    fixed by the shapes."""
    return max(1, min(MAX_WALKERS, -(-N // ROWS_PER_TILE)))


class StatsPlan(NamedTuple):
    """What ``vq_stats_launch`` is given and what its statistics pass does."""

    walkers: int  # G: blocks per head, each walking the row tiles g, g + G, ...
    shared_bytes: int  # dynamic shared memory per block
    acc_stride: int  # row stride of the sums accumulators
    j_chunks: int  # items of the pass: j in chunks of 32 lanes ...
    k_slices: int  # ... by slices of the codewords, one item per warp
    slice_width: int  # codewords per slice


def stats_plan(N: int, d: int, K: int) -> StatsPlan:
    chunks = -(-d // 32)
    slices = max(1, WARPS // chunks)
    return StatsPlan(stats_walkers(N), stats_shared_bytes(d, K), acc_stride(K), chunks, slices, -(-K // slices))


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
    if N == 0:
        return idx, quant
    KERNEL.launch(
        x.data_ptr(), x.stride(0), x.stride(1), embed.data_ptr(),
        idx.data_ptr(), quant.data_ptr(), N, H, d, K,
    )
    return idx, quant


def _split_stats(flat: torch.Tensor, H: int, d: int, K: int):
    """counts [H, K] and sums [H, d, K] as views of one flat buffer."""
    return flat[: H * K].view(H, K), flat[H * K :].view(H, d, K)


def _vq_nearest_stats_flat(x: torch.Tensor, embed: torch.Tensor, mask: torch.Tensor):
    """The statistics kernel with counts and sums in one flat buffer of
    ``H*K + H*d*K`` floats (counts first), so that one collective carries
    both. -> (idx, quant, flat)."""
    N, H, d, K = _check_cuda_inputs("vq_nearest_stats", x, embed, stats_shared_bytes)
    if mask.dtype != torch.float32 or tuple(mask.shape) != (N,):
        raise ValueError(f"vq_nearest_stats: mask must be float32 [{N}], got {mask.dtype} {tuple(mask.shape)}")
    if mask.device != x.device or not mask.is_contiguous():
        raise ValueError("vq_nearest_stats: mask must be a contiguous tensor on x's device")
    idx = torch.empty((N, H), dtype=torch.int32, device=x.device)
    quant = torch.empty((N, H, d), dtype=torch.float32, device=x.device)
    if N == 0:  # nothing to launch: the statistics of no rows are zeros
        return idx, quant, torch.zeros(H * K + H * d * K, dtype=torch.float32, device=x.device)
    flat = torch.empty(H * K + H * d * K, dtype=torch.float32, device=x.device)  # the kernel writes every cell
    counts, sums = _split_stats(flat, H, d, K)
    G = stats_plan(N, d, K).walkers
    part = torch.empty((G, H, K + d * K), dtype=torch.float32, device=x.device)
    STATS_KERNEL.launch(
        x.data_ptr(), x.stride(0), x.stride(1), embed.data_ptr(), mask.data_ptr(),
        idx.data_ptr(), quant.data_ptr(), part.data_ptr(), counts.data_ptr(), sums.data_ptr(),
        N, H, d, K, G,
    )
    return idx, quant, flat


def vq_nearest_stats(x: torch.Tensor, embed: torch.Tensor, mask: torch.Tensor):
    """x [N, H, d] (unit stride in d), embed [H, d, K] contiguous fp32,
    mask [N] fp32 row weights (1 = a valid frame) -> (idx [N, H] int32,
    quant [N, H, d], counts [H, K], sums [H, d, K]), all fp32. Rows with
    mask 0 still get idx and quant; only the statistics leave them out."""
    if x.device.type == "cpu":
        return vq_nearest_stats_plain(x, embed, mask)
    idx, quant, flat = _vq_nearest_stats_flat(x, embed, mask)
    H, d, K = embed.shape
    return (idx, quant, *_split_stats(flat, H, d, K))


def vq_nearest_stats_sharded_plain(x: torch.Tensor, embed: torch.Tensor, mask: torch.Tensor, group=None):
    """Plain PyTorch: :func:`vq_nearest_stats_plain` on the rank's rows,
    then the same single ``all_reduce(SUM)`` of counts and sums."""
    idx, quant, counts, sums = vq_nearest_stats_plain(x, embed, mask)
    H, d, K = embed.shape
    flat = all_reduce_sum(torch.cat([counts.reshape(-1), sums.reshape(-1)]), group)
    return (idx, quant, *_split_stats(flat, H, d, K))


def vq_nearest_stats_sharded(x: torch.Tensor, embed: torch.Tensor, mask: torch.Tensor, group=None):
    """:func:`vq_nearest_stats` on this rank's rows ``x`` [n, H, d] and
    ``mask`` [n], with ``counts`` and ``sums`` summed over the ranks of
    ``group`` by one ``all_reduce`` of ``H*K + H*d*K`` floats -> (idx [n, H],
    quant [n, H, d], counts [H, K], sums [H, d, K]); the last two are global
    and bit-equal on every rank. A rank with no rows, or with every row
    masked, enters the collective with zeros. Without a group, or in a group
    of one, this is :func:`vq_nearest_stats` bit for bit and nothing is
    communicated.

    The order of a rank's partial sums follows ``stats_walkers(n)`` of its
    own row count, and the ranks' partials are then added by the collective,
    so against one rank on all rows the sums differ by rounding (counts, idx
    and quant are exact)."""
    if x.device.type == "cpu":
        return vq_nearest_stats_sharded_plain(x, embed, mask, group)
    idx, quant, flat = _vq_nearest_stats_flat(x, embed, mask)
    H, d, K = embed.shape
    return (idx, quant, *_split_stats(all_reduce_sum(flat, group), H, d, K))


def vq_nearest_sharded_plain(x: torch.Tensor, embed: torch.Tensor):
    """Plain PyTorch: :func:`vq_nearest_plain` on the rank's rows."""
    return vq_nearest_plain(x, embed)


def vq_nearest_sharded(x: torch.Tensor, embed: torch.Tensor):
    """:func:`vq_nearest` on this rank's rows: rows are independent and the
    codebook is replicated, so no rank talks to another."""
    if x.device.type == "cpu":
        return vq_nearest_sharded_plain(x, embed)
    return vq_nearest(x, embed)
