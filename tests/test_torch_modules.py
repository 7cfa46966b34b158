"""The port's modules against their flax counterparts on the tiny recipe
widths (tests/tiny.py), with the JAX-initialised weights carried over by
``msmctts_tpu_torch.weights``; and the weight mapping's round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmctts_tpu.models.hifigan import HifiGANGenerator, ResBlock2
from msmctts_tpu.models.modules import PriorPredictor
from msmctts_tpu.models.msmc_vqgan import MultiStageQuantizer
from msmctts_tpu.models.predictor import MultiStagePredictor
from msmctts_tpu.models.quantizer import lookup_codes
from msmctts_tpu.models.transformer import FFTBlocks, LengthRegulator, regulate_lengths
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.models import hifigan as t_hifigan
from msmctts_tpu_torch.models import modules as t_modules
from msmctts_tpu_torch.models import msmc_vqgan as t_msmc
from msmctts_tpu_torch.models import predictor as t_predictor
from msmctts_tpu_torch.models import quantizer as t_quantizer
from msmctts_tpu_torch.models import transformer as t_transformer
from tests.tiny import tiny_ae_config, tiny_am_config

torch.set_num_threads(2)

AE = tiny_ae_config("/unused").task["autoencoder"]
AM = tiny_am_config("/unused", "/unused").task["predictor"]
FFT_CFG = dict(max_seq_len=64, n_layers=2, n_head=2, d_k=8, d_v=8, d_model=16, d_inner=32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_gains(params, rng):
    """Give every weight-norm gain a random scale, so folded kernels differ
    from their direction tensors and outputs are O(1)."""
    def visit(node):
        for k, v in node.items():
            if isinstance(v, dict):
                visit(v)
            elif k == "g":
                node[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
    visit(params)
    return params


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def test_fft_blocks_match_flax(rng):
    B, T = 3, 20
    lengths = np.array([20, 13, 1])
    x = rng.normal(size=(B, T, 16)).astype(np.float32)
    pos = (np.arange(1, T + 1)[None] * (np.arange(T)[None] < lengths[:, None])).astype(np.int32)
    pos[0, -1] = 80  # beyond max_seq_len: clipped in both
    mod = FFTBlocks(**FFT_CFG)
    with jax.default_matmul_precision("highest"):
        params = _np_tree(mod.init(jax.random.PRNGKey(0), x, pos)["params"])
        want, want_mask = mod.apply({"params": params}, x, pos)
    port = t_transformer.FFTBlocks(**FFT_CFG)
    W.load_numpy_state(port, W.fft_blocks_from_jax(params))
    with torch.inference_mode():
        got, mask = port(_t(x), _t(pos, torch.long))
    _close(got, want)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


def test_fully_padded_rows_match_flax(rng):
    x = rng.normal(size=(1, 6, 16)).astype(np.float32)
    pos = np.zeros((1, 6), np.int32)  # an empty utterance: uniform softmax
    mod = FFTBlocks(**FFT_CFG)
    with jax.default_matmul_precision("highest"):
        params = _np_tree(mod.init(jax.random.PRNGKey(3), x, pos)["params"])
        want, _ = mod.apply({"params": params}, x, pos)
    port = t_transformer.FFTBlocks(**FFT_CFG)
    W.load_numpy_state(port, W.fft_blocks_from_jax(params))
    with torch.inference_mode():
        got, _ = port(_t(x), _t(pos, torch.long))
    _close(got, want)


def test_regulate_lengths_matches_jax(rng):
    x = rng.normal(size=(2, 5, 3)).astype(np.float32)
    # half-way values round to even in both; zeros and negatives drop phones
    dur = np.array([[2.5, 0.0, 3.5, 1.0, -1.0], [1.0, 4.0, 0.5, 2.0, 1.5]], np.float32)
    want = regulate_lengths(jnp.asarray(x), jnp.asarray(dur), 12)
    got = t_transformer.regulate_lengths(_t(x), _t(dur), 12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_length_regulator_matches_flax(rng):
    B, Lt, D = 2, 7, 16
    x = rng.normal(size=(B, Lt, D)).astype(np.float32)
    non_pad = (np.arange(Lt)[None] < np.array([7, 4])[:, None]).astype(np.float32)[..., None]
    mod = LengthRegulator(input_size=D, duration_predictor_filter_size=8)
    with jax.default_matmul_precision("highest"):
        params = _np_tree(mod.init(jax.random.PRNGKey(1), x, non_pad, max_out_len=32)["params"])
        params["DurationPredictor_0"]["Dense_0"]["bias"] = np.array([2.2], np.float32)
        want = mod.apply({"params": params}, x, non_pad, max_out_len=32)
    port = t_transformer.LengthRegulator(D, 8)
    W.load_numpy_state(port, W.duration_predictor_from_jax(params["DurationPredictor_0"], "duration_predictor"))
    with torch.inference_mode():
        got = port(_t(x), _t(non_pad), 32)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))  # durations
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))  # lengths
    _close(got[0], want[0])


def test_prior_predictor_matches_flax(rng):
    B, T, C = 2, 15, 16
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([15, 9])[:, None]).astype(np.float32)[..., None]
    cfg = dict(kernel_size=3, dilation_rate=2, n_layers=2)
    mod = PriorPredictor(in_channels=C, out_channels=12, **cfg)
    with jax.default_matmul_precision("highest"):
        params = _perturb_gains(_np_tree(mod.init(jax.random.PRNGKey(2), x, mask)["params"]), rng)
        want_h, want_p = mod.apply({"params": params}, x, mask)
    port = t_modules.PriorPredictor(C, 12, **cfg)
    W.load_numpy_state(port, W.prior_predictor_from_jax(params))
    with torch.inference_mode():
        got_h, got_p = port(_t(x), _t(mask))
    _close(got_h, want_h)
    _close(got_p, want_p)


def test_hifigan_generator_matches_flax(rng):
    dec = dict(AE["decoder_config"], resblock_kernel_sizes=[3, 5], resblock_dilation_sizes=[[1, 3], [1, 2]])
    x = rng.normal(size=(2, 11, 16)).astype(np.float32)
    mod = HifiGANGenerator(num_mels=16, **dec)
    with jax.default_matmul_precision("highest"):
        params = _perturb_gains(_np_tree(mod.init(jax.random.PRNGKey(4), x)["params"]), rng)
        want = mod.apply({"params": params}, x)
    port = t_hifigan.HifiGANGenerator(num_mels=16, **dec)
    W.load_numpy_state(port, W.hifigan_generator_from_jax(params))
    with torch.inference_mode():
        got = port(_t(x))
    assert got.shape == want.shape == (2, 11 * 4, 1)
    _close(got, want)
    assert np.abs(np.asarray(want)).max() > 1e-2  # not a trivially small signal


def test_resblock2_matches_flax(rng):
    C, k, dils = 8, 5, (1, 3)
    x = rng.normal(size=(2, 19, C)).astype(np.float32)
    mod = ResBlock2(C, k, dils)
    with jax.default_matmul_precision("highest"):
        params = _perturb_gains(_np_tree(mod.init(jax.random.PRNGKey(7), x)["params"]), rng)
        want = mod.apply({"params": params}, x)
    port = t_hifigan.ResBlock2(C, k, dils)
    sd = {}
    for i in range(len(dils)):
        sd.update(W.wn_conv_from_jax(params[f"conv_{i}"], f"convs.{i}"))
    W.load_numpy_state(port, sd)
    with torch.inference_mode():
        got = port(_t(x))
    _close(got, want)


def test_lookup_codes_matches_jax(rng):
    embed = rng.normal(size=(3, 4, 6)).astype(np.float32)
    idx = rng.integers(0, 6, size=(2, 5, 3))
    want = lookup_codes(jnp.asarray(idx), jnp.asarray(embed))
    got = t_quantizer.lookup_codes(_t(idx), _t(embed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _quantizer_setup(rng):
    q = AE["quantizer_config"]
    kw = dict(
        n_model_size=16, upsample_scales=[2, 1], embedding_sizes=q["embedding_sizes"],
        embedding_dims=q["embedding_dims"], n_heads=q["n_heads"], prior_config=dict(q["prior_config"]),
    )
    B, T = 2, 12
    lengths = np.array([12, 7])
    fine = rng.normal(size=(B, T, 16)).astype(np.float32)
    coarse = rng.normal(size=(B, T // 2, 16)).astype(np.float32)
    stages = [(fine, lengths), (coarse, (lengths + 1) // 2)]  # fine-to-coarse
    mod = MultiStageQuantizer(**kw)
    with jax.default_matmul_precision("highest"):
        variables = _np_tree(mod.init(jax.random.PRNGKey(5), stages))
    _perturb_gains(variables["params"], rng)
    port = t_msmc.MultiStageQuantizer(**kw)
    W.load_numpy_state(port, W.multi_stage_quantizer_from_jax(variables["params"], variables["codebook"]))
    return mod, variables, port, stages


@pytest.mark.parametrize("from_encoder", [True, False])
def test_multi_stage_quantizer_matches_flax(rng, from_encoder):
    mod, variables, port, stages = _quantizer_setup(rng)
    if not from_encoder:
        stages = stages[::-1]  # coarsest-first predicted embeddings
    with jax.default_matmul_precision("highest"):
        want = mod.apply(variables, stages, from_encoder=from_encoder)
    with torch.inference_mode():
        got = port([(_t(e), _t(l, torch.long)) for e, l in stages], from_encoder=from_encoder)
    for g, w in zip(got["quantizer_indices"], want["quantizer_indices"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got["quantizer_outputs"], want["quantizer_outputs"]):
        _close(g, w, 1e-5)
    _close(got["residual_output"], want["residual_output"])


def _predictor_setup(rng):
    kw = {k: v for k, v in AM.items() if not k.startswith("_")}
    B, Lt = 2, 9
    text_length = np.array([9, 5])
    text = rng.integers(1, 5, size=(B, Lt, 2)) * (np.arange(Lt)[None, :, None] < text_length[:, None, None])
    dur = rng.integers(1, 5, size=(B, Lt)).astype(np.float32) * (np.arange(Lt)[None] < text_length[:, None])
    mod = MultiStagePredictor(**kw)
    with jax.default_matmul_precision("highest"):
        params = _np_tree(mod.init(jax.random.PRNGKey(6), text, text_length, dur=dur, max_frames=64)["params"])
    params = MultiStagePredictor.bias_durations(params, 2.6)
    port = t_predictor.MultiStagePredictor(**kw)
    W.load_numpy_state(port, W.multi_stage_predictor_from_jax(params))
    return mod, params, port, text, text_length, dur


def test_multi_stage_predictor_matches_flax(rng):
    mod, params, port, text, text_length, dur = _predictor_setup(rng)
    codebooks = [rng.normal(size=(2, 8, 8)).astype(np.float32) for _ in range(2)]
    with jax.default_matmul_precision("highest"):
        want = mod.apply({"params": params}, text, text_length, dur=dur, max_frames=64,
                         codebooks=[jnp.asarray(c) for c in codebooks])
        want_dur = mod.apply({"params": params}, text, text_length, method="predict_durations")
    with torch.inference_mode():
        got = port(_t(text, torch.long), _t(text_length, torch.long), dur=_t(dur), max_frames=64,
                   codebooks=[_t(c) for c in codebooks])
        got_dur = port.predict_durations(_t(text, torch.long), _t(text_length, torch.long))
    np.testing.assert_array_equal(got_dur.numpy(), np.asarray(want_dur))
    np.testing.assert_array_equal(got["duration"].numpy(), np.asarray(want["duration"]))
    for g, w in zip(got["feat_length"], want["feat_length"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got["feat"], want["feat"]):  # snapped: exact codewords
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bias_durations_matches_flax(rng):
    _, params, port, *_ = _predictor_setup(rng)
    bias = params["upsampler"]["DurationPredictor_0"]["Dense_0"]["bias"]
    port.bias_durations(2.6)
    assert port.upsampler.duration_predictor.linear_layer.bias.item() == pytest.approx(float(bias[0]))


def _round_trip(sd, to_jax, from_jax):
    back = from_jax(to_jax(sd))
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


def test_weight_round_trip_autoencoder():
    kw = {k: v for k, v in AE.items() if not k.startswith("_")}
    port = t_msmc.MSMCVQGAN(**kw)
    W.init_random(port, seed=0)
    _round_trip(W.state_dict_numpy(port), W.msmc_vqgan_to_jax, W.msmc_vqgan_from_jax)


def test_weight_round_trip_predictor():
    kw = {k: v for k, v in AM.items() if not k.startswith("_")}
    port = t_predictor.MultiStagePredictor(**kw)
    W.init_random(port, seed=1)
    _round_trip(W.state_dict_numpy(port), W.multi_stage_predictor_to_jax, W.multi_stage_predictor_from_jax)


def test_weight_round_trip_single_stream_predictor():
    kw = {k: v for k, v in AM.items() if not k.startswith("_")}
    kw["n_symbols"] = 20
    port = t_predictor.MultiStagePredictor(**kw)
    W.init_random(port, seed=2)
    sd = W.state_dict_numpy(port)
    assert "word_emb.weight" in sd
    _round_trip(sd, W.multi_stage_predictor_to_jax, W.multi_stage_predictor_from_jax)
