"""The port's ops against the JAX package on the CPU: the VQ snap's and the
fused resblock layer's plain versions (what the CUDA kernels are held
against on the card), and the weight-norm convs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmctts_tpu.models.quantizer import lookup_codes, nearest_codes
from msmctts_tpu.ops.convs import WNConv, WNConvTranspose1d
from msmctts_tpu.ops.fused_generator import _resblock
from msmctts_tpu.ops.pallas_resblock import fused_resblock_layer
from msmctts_tpu.ops.pallas_vq import vq_nearest
from msmctts_tpu_torch.ops import convs as tconvs
from msmctts_tpu_torch.ops.resblock import fused_resblock_layer_plain
from msmctts_tpu_torch.ops.vq import vq_nearest as t_vq_nearest
from msmctts_tpu_torch.weights import load_numpy_state, wn_conv_from_jax, wn_conv_transpose1d_from_jax

torch.set_num_threads(2)


def _vq_inputs(rng, N, H, d, K, tie=False):
    x = rng.normal(size=(N, H, d)).astype(np.float32)
    embed = rng.normal(size=(H, d, K)).astype(np.float32)
    if tie:
        # codewords 2 and 5 of every head are identical, and some rows sit
        # exactly on them: both distances are equal, the first must win
        embed[:, :, 5] = embed[:, :, 2]
        x[::3] = embed[:, :, 2][None]
    return x, embed


@pytest.mark.parametrize(
    "N,H,d,K,tie",
    [(37, 2, 8, 16, False), (300, 4, 64, 64, False), (1, 4, 64, 64, False), (48, 4, 64, 64, True)],
    ids=["ragged", "csmsc", "one-row", "exact-tie"],
)
def test_vq_plain_matches_jax(rng, N, H, d, K, tie):
    x, embed = _vq_inputs(rng, N, H, d, K, tie)
    idx, quant = t_vq_nearest(torch.from_numpy(x), torch.from_numpy(embed))
    with jax.default_matmul_precision("highest"):
        j_idx, _ = nearest_codes(jnp.asarray(x), jnp.asarray(embed))
        j_quant = lookup_codes(j_idx, jnp.asarray(embed))
        p_idx, p_quant = vq_nearest(jnp.asarray(x), jnp.asarray(embed), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(p_idx))
    np.testing.assert_allclose(quant.numpy(), np.asarray(j_quant), atol=1e-6, rtol=0)
    np.testing.assert_allclose(quant.numpy(), np.asarray(p_quant), atol=1e-6, rtol=0)
    if tie:
        assert (idx.numpy()[::3] == 2).all()


def test_vq_plain_takes_strided_rows(rng):
    x, embed = _vq_inputs(rng, 24, 4, 8, 16)
    wide = np.concatenate([x, x], axis=-1)  # stride 16 in d-blocks
    sl = torch.from_numpy(wide)[..., :8]
    idx, quant = t_vq_nearest(sl, torch.from_numpy(embed))
    ref_idx, ref_quant = t_vq_nearest(torch.from_numpy(x), torch.from_numpy(embed))
    assert torch.equal(idx, ref_idx) and torch.equal(quant, ref_quant)


def _resblock_weights(rng, C, k):
    w1 = rng.normal(size=(k, C, C)).astype(np.float32) * (k * C) ** -0.5
    w2 = rng.normal(size=(k, C, C)).astype(np.float32) * (k * C) ** -0.5
    b1 = rng.normal(size=(C,)).astype(np.float32) * 0.1
    b2 = rng.normal(size=(C,)).astype(np.float32) * 0.1
    return w1, b1, w2, b2


def _plain(x, w1, b1, w2, b2, d):
    t = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]
    return fused_resblock_layer_plain(*t, d).numpy()


@pytest.mark.parametrize("k,d,T", [(3, 1, 70), (11, 5, 41)])
def test_resblock_plain_matches_pallas_kernel(rng, k, d, T):
    C = 128
    x = rng.normal(size=(2, T, C)).astype(np.float32)
    w1, b1, w2, b2 = _resblock_weights(rng, C, k)
    with jax.default_matmul_precision("highest"):
        want = fused_resblock_layer(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)), d, interpret=True)
    np.testing.assert_allclose(_plain(x, w1, b1, w2, b2, d), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("C", [64, 32])
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("d", [1, 3, 5])
def test_resblock_plain_matches_unfused_jax(rng, C, k, d):
    T = 57
    x = rng.normal(size=(2, T, C)).astype(np.float32)
    w1, b1, w2, b2 = _resblock_weights(rng, C, k)
    # the JAX unfused layer takes weight-norm params; g = |v| folds to v
    def wn(w, b):
        return {"v": w, "g": np.sqrt((w.astype(np.float64) ** 2).sum(axis=(0, 1))).astype(np.float32), "bias": b}
    params = {"conv1_0": wn(w1, b1), "conv2_0": wn(w2, b2)}
    with jax.default_matmul_precision("highest"):
        want = _resblock(params, jnp.asarray(x), k, (d,), use_pallas=False)
    np.testing.assert_allclose(_plain(x, w1, b1, w2, b2, d), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("k,pad,dil", [(7, 3, 1), (3, 3, 3), (1, 0, 1)])
def test_wn_conv_matches_jax(rng, k, pad, dil):
    cin, cout, T = 6, 10, 23
    x = rng.normal(size=(2, T, cin)).astype(np.float32)
    mod = WNConv(cout, (k,), padding=pad, dilation=dil)
    with jax.default_matmul_precision("highest"):
        params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        params["g"] = params["g"] * rng.uniform(0.5, 2.0, size=params["g"].shape).astype(np.float32)
        params["bias"] = rng.normal(size=(cout,)).astype(np.float32)
        want = mod.apply({"params": params}, jnp.asarray(x))
    conv = tconvs.WNConv1d(cin, cout, k, padding=pad, dilation=dil)
    load_numpy_state(conv, {k_[5:]: v for k_, v in wn_conv_from_jax(params, "conv").items()})
    got = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,u", [(12, 6), (11, 5), (4, 2)])
def test_wn_conv_transpose_matches_jax(rng, k, u):
    cin, cout, T = 8, 5, 9
    x = rng.normal(size=(2, T, cin)).astype(np.float32)
    mod = WNConvTranspose1d(cout, k, u, (k - u) // 2)
    with jax.default_matmul_precision("highest"):
        params = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        params["g"] = params["g"] * rng.uniform(0.5, 2.0, size=params["g"].shape).astype(np.float32)
        params["bias"] = rng.normal(size=(cout,)).astype(np.float32)
        want = mod.apply({"params": params}, jnp.asarray(x))
    conv = tconvs.WNConvTranspose1d(cin, cout, k, u, (k - u) // 2)
    load_numpy_state(conv, {k_[3:]: v for k_, v in wn_conv_transpose1d_from_jax(params, "up").items()})
    got = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert got.shape[1] == T * u  # (L - 1) u - 2p + k
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_fold_is_refreshed_after_load():
    conv = tconvs.WNConv1d(3, 4, 3, padding=1)
    before = conv.weight.clone()
    sd = {k: v.clone() for k, v in conv.state_dict().items()}
    sd["weight_g"] = sd["weight_g"] * 2
    conv.load_state_dict(sd)
    torch.testing.assert_close(conv.weight, before * 2)
