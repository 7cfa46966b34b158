"""The numerics and the shared-memory plan of the port's tensor-core MRF
kernel, on the CPU: the TF32 split, the 3xTF32 emulation of the layer
against the JAX package, the prepared weight stream, and the plan the
launcher takes its tile rows, ring depth and shared bytes from."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmctts_tpu.ops.fused_generator import _resblock
from msmctts_tpu.ops.pallas_resblock import fused_resblock_layer
from msmctts_tpu_torch.models.hifigan import ResBlock1
from msmctts_tpu_torch.ops import resblock as rb
from msmctts_tpu_torch.ops import vq

torch.set_num_threads(2)

CSRC = Path(rb.__file__).resolve().parents[1] / "csrc"
# The split emulation against fp32 references that sum in another order.
# Dropping a_lo*b_lo and rounding the tails costs 2^-21 relative per product,
# far below fp32's own summation error over k*C <= 2816 terms of size <= 1,
# which is what this tolerance covers (measured: under 3e-6).
SPLIT_ATOL = 2e-5
CSMSC_LAYERS = [(C, k, d) for C in (256, 128, 64, 32) for k in (3, 7, 11) for d in (1, 3, 5)]


def _layer(rng, C, k, T, B=2):
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    s = (k * C) ** -0.5
    w1 = rng.normal(size=(k, C, C)).astype(np.float32) * s
    w2 = rng.normal(size=(k, C, C)).astype(np.float32) * s
    b1 = rng.normal(size=(C,)).astype(np.float32) * 0.1
    b2 = rng.normal(size=(C,)).astype(np.float32) * 0.1
    return x, w1, b1, w2, b2


def _split_plain(args, d):
    return rb.fused_resblock_layer_split_plain(*(torch.from_numpy(a) for a in args), d).numpy()


@pytest.mark.parametrize("scale", [1.0, 1e-20, 3e4])
def test_tf32_split_keeps_fp32(rng, scale):
    x = torch.from_numpy((rng.normal(size=4096) * scale).astype(np.float32))
    hi, lo = rb.tf32_split(x)
    for part in (hi, lo):  # both lie on the TF32 grid: 13 low mantissa bits clear
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((hi - x).abs() / x.abs()).max()) <= 2.0**-11
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0**-21


def test_tf32_split_rounds_to_nearest_ties_away():
    ulp = 2.0**-10  # of TF32 at 1.0
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2), 0.0, 1.0], dtype=torch.float32)
    hi, lo = rb.tf32_split(x)
    assert hi.tolist() == [1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 0.0, 1.0]
    assert torch.equal(hi + lo, x)


@pytest.mark.parametrize("C,k,d", [(128, 11, 5), (256, 3, 1)])
def test_split_plain_matches_pallas_kernel(rng, C, k, d):
    args = _layer(rng, C, k, 70)
    with jax.default_matmul_precision("highest"):
        want = fused_resblock_layer(*(jnp.asarray(a) for a in args), d, interpret=True)
    np.testing.assert_allclose(_split_plain(args, d), np.asarray(want), rtol=0, atol=SPLIT_ATOL)


@pytest.mark.parametrize("C,k,d", [(64, 11, 3), (64, 3, 1), (32, 7, 5), (32, 11, 1)])
def test_split_plain_matches_unfused_jax(rng, C, k, d):
    args = _layer(rng, C, k, 70)
    x, w1, b1, w2, b2 = args

    def wn(w, b):  # the JAX unfused layer takes weight-norm params; g = |v| folds to v
        return {"v": w, "g": np.sqrt((w.astype(np.float64) ** 2).sum(axis=(0, 1))).astype(np.float32), "bias": b}

    with jax.default_matmul_precision("highest"):
        want = _resblock({"conv1_0": wn(w1, b1), "conv2_0": wn(w2, b2)}, jnp.asarray(x), k, (d,), use_pallas=False)
    np.testing.assert_allclose(_split_plain(args, d), np.asarray(want), rtol=0, atol=SPLIT_ATOL)


@pytest.mark.parametrize("C,k,d,T", [(8, 3, 1, 5), (8, 7, 3, 2), (16, 11, 5, 19), (24, 3, 5, 1)])
def test_split_plain_matches_plain_at_tiny_widths(rng, C, k, d, T):
    """Halo wider than T, T = 1: the zero padding and the mid mask."""
    args = _layer(rng, C, k, T)
    want = rb.fused_resblock_layer_plain(*(torch.from_numpy(a) for a in args), d).numpy()
    np.testing.assert_allclose(_split_plain(args, d), want, rtol=0, atol=SPLIT_ATOL)


def test_single_pass_tf32_would_not_hold(rng):
    """What the split is for: the heads alone miss the tolerance by far."""
    args = [torch.from_numpy(a) for a in _layer(rng, 128, 11, 70)]
    x, w1, b1, w2, b2 = args
    want = rb.fused_resblock_layer_plain(*args, 5)
    heads = rb.fused_resblock_layer_plain(x, rb.tf32_split(w1)[0], b1, rb.tf32_split(w2)[0], b2, 5)
    assert float((heads - want).abs().max()) > 10 * SPLIT_ATOL


@pytest.mark.parametrize("C,k", [(8, 3), (32, 11), (128, 7)])
def test_prepared_taps_round_trip(rng, C, k):
    _, w1, _, w2, _ = (torch.from_numpy(a) for a in _layer(rng, C, k, 1))
    prepared = rb.prepare_taps(w1, w2)
    assert prepared.shape == (4 * k * C * C,) and prepared.dtype == torch.float32 and prepared.is_contiguous()
    for got, want in zip(rb.taps_from_prepared(prepared, k, C), (w1, w2)):
        assert float(((got - want).abs() / want.abs()).max()) <= 2.0**-21
    # one element by hand: conv 1 (the second), tap j, c_in -> c_out, head then tail
    j, ci, co = k - 1, C - 3, 5
    hi, lo = rb.tf32_split(w2)
    per_slice = 2 * C * 8
    at = ((k + j) * (C // 8) + ci // 8) * per_slice + (co // 8) * 64 + (ci % 8 // 4) * 32 + (co % 8) * 4 + ci % 4
    assert prepared[at] == hi[j, ci, co] and prepared[at + C * 8] == lo[j, ci, co]


def test_fold_refreshes_the_prepared_taps():
    torch.manual_seed(0)
    block = ResBlock1(8, 3, (1, 3))
    for i in range(2):
        want = rb.prepare_taps(getattr(block, f"taps1_{i}"), getattr(block, f"taps2_{i}"))
        assert torch.equal(getattr(block, f"prepared_{i}"), want)
    stale = block.prepared_1.clone()
    state = {name: t.clone() for name, t in block.state_dict().items()}
    assert not any("prepared" in name or "taps" in name for name in state)  # derived, never saved
    state["convs2.1.weight_g"] = state["convs2.1.weight_g"] * 2
    block.load_state_dict(state)
    assert not torch.equal(block.prepared_1, stale)
    assert torch.equal(block.prepared_1, rb.prepare_taps(block.taps1_1, block.taps2_1))
    w1, w2 = rb.taps_from_prepared(block.prepared_1, 3, 8)
    torch.testing.assert_close(w2, block.taps2_1, rtol=2.0**-21, atol=0)
    with torch.no_grad():
        block.convs1[0].weight_g.mul_(3.0)
    block.train()
    block.eval()  # the switch to eval folds again
    assert torch.equal(block.prepared_0, rb.prepare_taps(block.taps1_0, block.taps2_0))
    x = torch.randn(1, 9, 8)
    torch.testing.assert_close(block(x), block.forward_ncl(x.transpose(1, 2)).transpose(1, 2), rtol=1e-5, atol=1e-5)


def _kernel_bodies():
    """{C: (rows per block, k8 slices per slab, blocks per SM)} as csrc/resblock.cu instantiates them."""
    src = (CSRC / "resblock.cu").read_text()
    bodies = {}
    for C, NW, blocks in re.findall(r"case (\d+): return launch<\1, (\d+), (\d+)>", src):
        C, NW, blocks = int(C), int(NW), int(blocks)
        row_groups = 2 // (C // NW)  # the two warpgroups side by side in C_out, or stacked in time
        bodies[C] = (row_groups * 64, min(C // 8, 256 // C), blocks)
    return bodies


def test_plan_table_is_the_kernels():
    assert _kernel_bodies() == rb.BODIES
    src = (CSRC / "resblock.cu").read_text()
    assert int(re.search(r"kMaxStages = (\d+)", src).group(1)) >= rb.MAX_STAGES
    assert "smem + 128" in src and rb.BARRIER_BYTES == 128


@pytest.mark.parametrize("C,k,d", CSMSC_LAYERS)
def test_plan_fits_every_csmsc_layer(C, k, d):
    plan = rb.plan_layer(C, k, d)
    tile, slab_steps, blocks = rb.BODIES[C]
    assert plan.body == "wgmma-3xtf32"
    assert plan.tile == tile == rb.choose_tile(C, k, d) and tile % 64 == 0
    assert plan.out_rows == tile - (k - 1) > 0
    assert plan.slab_bytes == slab_steps * C * 64 and plan.slab_bytes % 16 == 0
    assert 2 <= plan.stages <= rb.MAX_STAGES
    # barriers + ring + one fp32 plane of tile + conv1's halo rows, C + 4 floats a row
    want = 128 + plan.stages * plan.slab_bytes + (tile + (k - 1) * d) * (C + 4) * 4
    assert plan.shared_bytes == want == rb.shared_bytes(C, k, d, tile, plan.stages) <= rb.MAX_SHARED_BYTES
    if plan.shared_bytes <= rb.SM_SHARED_BYTES // blocks - 1024:  # the width's blocks per SM fit together
        assert blocks * (plan.shared_bytes + 1024) <= rb.SM_SHARED_BYTES
    # the ring never ends inside a conv's last slab: slabs divide a tap's slices
    assert (C // 8) % slab_steps == 0


@pytest.mark.parametrize("C,k,d", [(512, 3, 1), (1024, 11, 5), (48, 3, 1)])
def test_plan_refuses_other_widths_by_name(C, k, d):
    with pytest.raises(ValueError, match=rf"C={C}, k={k}, dilation={d} does not fit"):
        rb.plan_layer(C, k, d)


def test_plan_refuses_a_halo_beyond_shared_memory():
    assert rb.plan_layer(256, 11, 9).shared_bytes <= rb.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match=r"C=256, k=11, dilation=40 does not fit in shared memory"):
        rb.plan_layer(256, 11, 40)
    with pytest.raises(ValueError, match="does not fit"):
        rb.plan_layer(256, 65, 1)  # more taps than rows in a tile


def test_vq_shared_memory_follows_the_kernels():
    src = (CSRC / "vq_common.cuh").read_text()
    assert int(re.search(r"kWarps = (\d+)", src).group(1)) == vq.WARPS
    assert int(re.search(r"kRowsPerBlock = (\d+)", src).group(1)) == vq.ROWS_PER_TILE
    assert int(re.search(r"kGroup = (\d+)", src).group(1)) == vq.GROUP
    assert vq.ROWS_PER_TILE == vq.WARPS * vq.GROUP  # one row group per warp and tile
    d = K = 64  # CSMSC: codebook, its transpose (rows of d + 4), norms, row groups, indices
    assert vq.shared_bytes(d, K) == (d * K + K * (d + 4) + K + 8 * 8 * d + 8 * 8) * 4
    assert vq.stats_shared_bytes(d, K) == (d * K + K * (d + 4) + K + (K + d * K) + 64 * d + 2 * 64) * 4
    assert max(vq.shared_bytes(d, K), vq.stats_shared_bytes(d, K)) <= vq.MAX_SHARED_BYTES
