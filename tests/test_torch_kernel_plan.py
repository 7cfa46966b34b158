"""The numerics and the shared-memory plan of the port's tensor-core MRF
kernel, on the CPU: the TF32 split, the 3xTF32 emulation of the layer
against the JAX package, the prepared weight stream, and the plan the
launcher takes its tile rows, ring depth and shared bytes from. Then the
VQ kernels' shared memory, and the plan and the statistics pass of
csrc/vq_stats.cu: walkers, the owner of every cell, the order in which an
owner adds its rows, and the accumulators' banks."""

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


def _stats_source():
    return (CSRC / "vq_stats.cu").read_text()


def _stats_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _stats_source()).group(1))


def _launcher_smem_floats(d, K):
    """The dynamic shared memory vq_stats_launch asks for, in floats, by
    evaluating the expression of its source."""
    src = _stats_source()
    expr = re.search(r"const size_t smem = \(size_t\)\((.*?)\) \* sizeof\(float\);", src, re.S).group(1)
    expr = " ".join(expr.replace("vq::et_stride", "et_stride").split())
    names = {"d": d, "K": K, "kRowsPerBlock": vq.ROWS_PER_TILE, "kWarps": vq.WARPS,
             "et_stride": lambda d: (d + 3) // 4 * 4 + 4, "acc_stride": vq.acc_stride}
    return eval(expr, {}, names)  # noqa: S307 (an arithmetic expression of the kernel's source)


def test_vq_shared_memory_follows_the_kernels():
    src = (CSRC / "vq_common.cuh").read_text()
    assert int(re.search(r"kWarps = (\d+)", src).group(1)) == vq.WARPS
    assert int(re.search(r"kRowsPerBlock = (\d+)", src).group(1)) == vq.ROWS_PER_TILE
    assert int(re.search(r"kGroup = (\d+)", src).group(1)) == vq.GROUP
    assert vq.ROWS_PER_TILE == vq.WARPS * vq.GROUP  # one row group per warp and tile
    stats = _stats_source()
    assert "__launch_bounds__(kWarps * 32, kBlocksPerSM)" in stats
    # the pass's layout, as stats_plan describes it
    assert "acc_stride(int K) { return K | 1; }" in stats
    assert "j_chunks(int d) { return (d + 31) / 32; }" in stats
    assert "k_slices(int d) { return max(1, kWarps / j_chunks(d)); }" in stats
    assert "const int width = (K + slices - 1) / slices;" in stats
    d = K = 64  # CSMSC: codebook, its transpose (rows of d + 4), norms, row groups, indices
    assert vq.shared_bytes(d, K) == (d * K + K * (d + 4) + K + 8 * 8 * d + 8 * 8) * 4
    # codebook, transpose, norms; the tile's rows; sums [d][K + 1] and counts; row weights and codes; a row list per warp
    assert vq.stats_shared_bytes(d, K) == (d * K + K * (d + 4) + K + 64 * d + d * (K + 1) + K + 2 * 64 + 8 * 64) * 4
    for d, K in ((64, 64), (3, 5), (96, 64), (64, 128), (300, 16), (1, 1)):
        assert vq.stats_shared_bytes(d, K) == _launcher_smem_floats(d, K) * 4
    assert max(vq.shared_bytes(64, 64), vq.stats_shared_bytes(64, 64)) <= vq.MAX_SHARED_BYTES
    # the blocks an SM holds by their register budget fit in its shared memory at the CSMSC codebook
    assert _stats_constant("kBlocksPerSM") * (vq.stats_shared_bytes(64, 64) + 1024) <= 233472


@pytest.mark.parametrize("N", [1, 7, 9, 64, 65, 1600, 2047, 6400])
def test_vq_stats_plan_depends_on_n_alone(N):
    """The walkers, and with them the order of every sum, follow N alone."""
    tiles = -(-N // vq.ROWS_PER_TILE)
    plans = [vq.stats_plan(N, d, K) for d, K in ((64, 64), (3, 5), (64, 128), (96, 32))]
    assert len({p.walkers for p in plans}) == 1
    G = plans[0].walkers
    assert G == vq.stats_walkers(N) == min(tiles, vq.MAX_WALKERS) and 1 <= G <= tiles
    plan = vq.stats_plan(N, 64, 64)
    assert plan.shared_bytes == vq.stats_shared_bytes(64, 64) <= vq.MAX_SHARED_BYTES
    assert (plan.acc_stride, plan.j_chunks, plan.k_slices, plan.slice_width) == (65, 2, 4, 16)


def _stats_owners(d, K):
    """{cell: [(warp, lane), ...]} of the statistics pass as csrc/vq_stats.cu
    deals it out: warp w takes the items w, w + kWarps, ...; item i covers
    j = (i % chunks) * 32 + lane and the codewords of slice i // chunks; the
    slice's counts go to lane 0 of its first chunk. Cells are ("sum", j, k)
    and ("count", k)."""
    plan = vq.stats_plan(1, d, K)
    owners = {}
    for item in range(plan.j_chunks * plan.k_slices):
        warp, chunk, q = item % vq.WARPS, item % plan.j_chunks, item // plan.j_chunks
        for k in range(q * plan.slice_width, min(K, (q + 1) * plan.slice_width)):
            for lane in range(32):
                j = chunk * 32 + lane
                if j < d:
                    owners.setdefault(("sum", j, k), []).append((warp, lane))
            if chunk == 0:
                owners.setdefault(("count", k), []).append((warp, 0))
    return owners


@pytest.mark.parametrize("d,K", [(64, 64), (3, 5), (96, 64), (64, 128), (300, 16), (32, 7)])
def test_vq_stats_every_cell_has_one_owner(d, K):
    owners = _stats_owners(d, K)
    want = {("sum", j, k) for j in range(d) for k in range(K)} | {("count", k) for k in range(K)}
    assert set(owners) == want
    assert all(len(o) == 1 for o in owners.values())
    assert {w for o in owners.values() for w, _ in o} <= set(range(vq.WARPS))
    if (d, K) == (64, 64):  # every warp works, on 32 x 16 sums cells, four of them also on 16 counts
        per_warp = np.bincount([o[0][0] for o in owners.values()], minlength=vq.WARPS)
        assert sorted(per_warp.tolist()) == [512] * 4 + [528] * 4


def _fma(a, b, c):
    """One rounding of a*b + c to fp32 (a*b is exact in fp64)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _pass_model(codes, w, x, k0, k1, j, acc, cnt, trace):
    """One warp's item on one tile, as csrc/vq_stats.cu runs it: the list of
    the rows whose code lies in [k0, k1), in rising order (ballot and prefix
    count per 32 rows), then batches of kRun rows; a batch past the list's
    end repeats its last row with weight 0; a row whose codeword an earlier
    row of the batch had starts from that row's result; stores in order."""
    rows = len(codes)
    lst = []
    for base in range(0, rows, 32):
        half = [r for r in range(base, min(rows, base + 32)) if k0 <= codes[r] < k1]
        lst.extend(half)
    n = len(lst)
    run = _stats_constant("kRun")
    for t in range(0, n, run):
        kk, ww, xv = [], [], []
        for u in range(run):
            real = t + u < n
            r = lst[t + u if real else n - 1]
            kk.append(codes[r])
            ww.append(w[r] if real else np.float32(0))
            xv.append(x[r, j] if real else np.float32(0))
            if real:
                trace.setdefault(codes[r], []).append(r)
        a = [acc[k] for k in kk]
        ca = [cnt[k] for k in kk]
        for u in range(run):
            for p in range(u):
                if kk[p] == kk[u]:
                    a[u], ca[u] = a[p], ca[p]
            a[u] = _fma(ww[u], xv[u], a[u])
            ca[u] = np.float32(ca[u] + ww[u])
        for u in range(run):
            acc[kk[u]], cnt[kk[u]] = a[u], ca[u]


@pytest.mark.parametrize("skew", ["uniform", "one-codeword", "runs"])
def test_vq_stats_owner_adds_its_rows_in_rising_order(rng, skew):
    """Over the tiles of a walker, the batched pass gives every cell the same
    fmaf chain, bit for bit, as adding its rows one at a time in rising order
    (the order a scan of all rows per cell gives), and each owner sees its
    rows in rising order; masked rows carry weight 0, a short last tile too."""
    d, K, width = 5, 64, 16
    tiles = []
    for rows in (64, 64, 37):
        if skew == "uniform":
            codes = rng.integers(0, K, size=rows)
        elif skew == "one-codeword":
            codes = np.where(rng.random(rows) < 0.9, 3, rng.integers(0, K, size=rows))
        else:
            codes = np.repeat(rng.integers(0, K, size=rows // 4 + 1), 4)[:rows]
        w = (rng.random(rows) < 0.8).astype(np.float32)
        x = rng.normal(size=(rows, d)).astype(np.float32)
        tiles.append((codes, w, x))
    for q in range(K // width):
        k0, k1 = q * width, (q + 1) * width
        for j in range(d):
            acc, cnt = np.zeros(K, np.float32), np.zeros(K, np.float32)
            want_acc, want_cnt = np.zeros(K, np.float32), np.zeros(K, np.float32)
            trace = {}
            for codes, w, x in tiles:
                seen = {}
                _pass_model(codes, w, x, k0, k1, j, acc, cnt, seen)
                for k, rows in seen.items():
                    assert rows == sorted(rows) == [r for r in range(len(codes)) if codes[r] == k]
                    trace.setdefault(k, []).extend(rows)
                for r in range(len(codes)):  # one row at a time, rising order
                    if k0 <= codes[r] < k1:
                        want_acc[codes[r]] = _fma(w[r], x[r, j], want_acc[codes[r]])
                        want_cnt[codes[r]] = np.float32(want_cnt[codes[r]] + w[r])
            assert acc.tobytes() == want_acc.tobytes() and cnt.tobytes() == want_cnt.tobytes()
            assert set(trace) <= set(range(k0, k1))


def test_vq_stats_accumulators_avoid_bank_conflicts():
    """A warp's 32 lanes hold consecutive j of one codeword k: with a row
    stride of K | 1 they read and write 32 different banks, for every K."""
    for K in range(1, 257):
        stride = vq.acc_stride(K)
        assert stride in (K, K + 1) and stride % 2 == 1
        for chunk in range(3):
            for k in range(K):
                banks = {((chunk * 32 + lane) * stride + k) % 32 for lane in range(32)}
                assert len(banks) == 32
    # a [d][K] layout would put all 32 in one bank at K = 64
    assert len({(lane * 64) % 32 for lane in range(32)}) == 1
