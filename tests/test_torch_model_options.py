"""The model options no shipped recipe sets, in the port against
msmctts_tpu on the CPU: the quantizer's ``sort``, ``restart_dead`` and
``sample``; ``TorchBatchNorm``, ResStack's global conditioning and
``Encoder``; the learned upsampler's transposed conv at u = 1-5;
``MSMCVQGAN`` with ``mapping`` / ``residual`` upsampling and
``norm: True``; FFN and duration-predictor convs with even kernels; every
converter they need, both ways; and the serving engine's frame margin over a
learned upsampler. The train steps and two ranks with these options are in
``tests/test_torch_model_options_train.py``.

Tolerances (fp32, JAX under matmul precision "highest").
  * indices, rankings, dead sets, restart seeds, the sampler's lookups:
    equal.
  * codebook entries that no restart touched: 1e-6 (an EMA of the same
    sums).
  * TorchBatchNorm: normalized output 1e-5, running statistics 1e-6 (a
    mean over a few hundred fp32 terms in another order), input gradient
    1e-5.
  * module outputs (ResStack, Encoder, FFT blocks, duration predictor,
    the upsampler's transposed conv): 1e-5; the autoencoder's waveform 1e-4 and its decoder features 1e-5,
    as ``test_torch_modules.py`` holds the repeat mode.
  * the sampler's frequencies: within 5 standard deviations of
    ``max(cluster_size, eps) / sum`` per head over 12 000 draws.
  * a request the serving engine decodes in a shared batch against the
    same request alone: 1e-6 absolute (observed: equal).
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmctts_tpu.models import modules as j_modules
from msmctts_tpu.models.msmc_vqgan import MSMCVQGAN as JAutoencoder
from msmctts_tpu.models.predictor import MultiStagePredictor as JPredictor
from msmctts_tpu.models.quantizer import EMAQuantizer as JQuantizer
from msmctts_tpu.models.quantizer import lookup_codes as j_lookup_codes
from msmctts_tpu.models.transformer import DurationPredictor as JDurationPredictor
from msmctts_tpu.models.transformer import FFTBlocks as JFFTBlocks
from msmctts_tpu.utils.checkpoint import save_checkpoint
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.data.datasets import FRAME_BUCKETS, bucket_length
from msmctts_tpu_torch.models import modules as t_modules
from msmctts_tpu_torch.models import msmc_vqgan as t_msmc
from msmctts_tpu_torch.models import transformer as t_transformer
from msmctts_tpu_torch.models.quantizer import EMAQuantizer as TQuantizer
from msmctts_tpu_torch.serving import BatchingEngine
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint as t_load_checkpoint
from tests.tiny import FRAMESHIFT, MEL_DIM, tiny_ae_config, tiny_am_config

torch.set_num_threads(2)

HIGHEST = jax.default_matmul_precision("highest")
CODEBOOK_TOL = 1e-6
BN_TOL = 1e-5
STATS_TOL = 1e-6
OUT_TOL = 1e-5
WAV_TOL = 1e-4
SOLO_TOL = 1e-6


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _gains(tree, rng):
    """Random weight-norm gains, so that a folded kernel is not its
    direction tensor and the outputs are O(1)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _gains(v, rng)
        elif k == "g":
            tree[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
    return tree


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=tol, atol=tol)


def _same_tree(got, want):
    """Nested dicts of arrays with equal keys and bit-equal leaves."""
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _same_tree(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# ------------------------------------------------------------------ quantizer


def _quantizer_pair(rng, H, D, K, **kw):
    jq = JQuantizer(embed_dim=D, n_embed=K, n_head=H, use_pallas=False, **kw)
    x0 = np.zeros((1, 1, D), np.float32)
    v = _np_tree(jq.init(jax.random.PRNGKey(H), x0, update=False))
    port = TQuantizer(D, K, n_head=H, **kw)
    W.load_numpy_state(port, W.quantize_from_jax(v["codebook"]))
    return jq, v, port


@pytest.mark.parametrize("H", [1, 2], ids=["one-head", "two-heads"])
def test_sort_ranking_matches_jax(rng, H):
    """``sort=True``: every codeword ranked nearest first, [B, T, K] for one
    head and [B, T, H, K] for more, in inference and in a training forward
    (whose EMA update follows JAX's too)."""
    D, K = 8, 16
    jq, v, port = _quantizer_pair(rng, H, D, K)
    x = rng.normal(size=(2, 7, D)).astype(np.float32)
    lengths = np.array([7, 4])
    with HIGHEST:
        _, _, want = jq.apply(v, x, sort=True)
        (_, _, want_train), mut = jq.apply(v, x, lengths, sort=True, mutable=["codebook"])
    port.eval()
    _, _, got = port(_t(x), sort=True)
    assert tuple(got.shape) == ((2, 7, K) if H == 1 else (2, 7, H, K)) == np.asarray(want).shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    port.train()
    _, _, got_train = port(_t(x), lengths=_t(lengths, torch.long), sort=True)
    np.testing.assert_array_equal(got_train.numpy(), np.asarray(want_train))
    for key in ("embed", "cluster_size", "embed_avg"):
        _close(getattr(port, key).numpy(), mut["codebook"][key], CODEBOOK_TOL)


def test_restart_dead_matches_jax(rng):
    """``restart_dead``: after the EMA update every codeword whose count fell
    below the threshold takes a row of the batch (padded rows included, as
    in JAX) as codeword and ``embed_avg``, and count 1.0. The dead set is
    JAX's; the seeds are the rows the port's own draw picked from the
    trainer's generator."""
    H, d, K = 2, 4, 16
    D, B, T = H * d, 3, 10
    threshold = 0.015  # from a zero count the EMA gives 0.01 per row: a codeword with < 2 rows dies
    lengths = np.array([10, 7, 4])
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    jq, v, port = _quantizer_pair(rng, H, D, K, restart_dead=threshold)
    jq_plain = JQuantizer(embed_dim=D, n_embed=K, n_head=H, use_pallas=False)
    with HIGHEST:
        _, mut = jq.apply(v, jnp.asarray(x), lengths, mutable=["codebook"], rngs={"dropout": jax.random.PRNGKey(3)})
        _, plain = jq_plain.apply(v, x, lengths, mutable=["codebook"])
    dead = np.asarray(plain["codebook"]["cluster_size"]) < threshold  # [H, K]
    assert 0 < dead.sum() < H * K
    np.testing.assert_array_equal(np.asarray(mut["codebook"]["cluster_size"]) == 1.0, dead)

    port.generator = torch.Generator().manual_seed(7)
    port.train()
    port(_t(x), lengths=_t(lengths, torch.long))
    draw = torch.randint(0, B * T, (H, K), generator=torch.Generator().manual_seed(7)).numpy()
    seeds = x.reshape(B * T, H, d)[draw, np.arange(H)[:, None]]  # [H, K, d]
    cs, embed, avg = port.cluster_size.numpy(), port.embed.numpy(), port.embed_avg.numpy()
    np.testing.assert_array_equal(cs == 1.0, dead)
    for h, k in zip(*np.nonzero(dead)):
        np.testing.assert_array_equal(embed[h, :, k], seeds[h, k])
        np.testing.assert_array_equal(avg[h, :, k], seeds[h, k])
    alive = ~dead
    _close(cs[alive], np.asarray(mut["codebook"]["cluster_size"])[alive], CODEBOOK_TOL)
    for got, key in ((embed, "embed"), (avg, "embed_avg")):
        want = np.asarray(mut["codebook"][key])
        _close(got.transpose(0, 2, 1)[alive], want.transpose(0, 2, 1)[alive], CODEBOOK_TOL)


def test_restart_dead_needs_the_trainers_generator(rng):
    port = TQuantizer(8, 4, n_head=2, restart_dead=0.5).train()
    with pytest.raises(RuntimeError, match="generator"):
        port(_t(rng.normal(size=(1, 3, 8)).astype(np.float32)))


def test_sample_draws_from_the_ema_counts(rng):
    """``sample``: per head a categorical over ``max(cluster_size, eps)``,
    then the lookup (``quantizer.py:244-259``); the shapes are JAX's."""
    H, d, K = 2, 3, 6
    jq, v, port = _quantizer_pair(rng, H, H * d, K)
    counts = rng.uniform(0.5, 4.0, size=(H, K)).astype(np.float32)
    counts[0, 2] = 0.0  # a dead codeword: eps, never drawn in practice
    with torch.no_grad():
        port.cluster_size.copy_(_t(counts))
    shape = (40, 300)
    idx, codes = port.sample(torch.Generator().manual_seed(0), shape)
    v["codebook"]["cluster_size"] = counts
    j_idx, j_codes = jq.apply(v, jax.random.PRNGKey(0), shape, method="sample")
    assert tuple(idx.shape) == np.asarray(j_idx).shape == (*shape, H)
    assert tuple(codes.shape) == np.asarray(j_codes).shape == (*shape, H, d)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_lookup_codes(jnp.asarray(idx.numpy()), v["codebook"]["embed"])))
    n = np.prod(shape)
    p = np.maximum(counts, TQuantizer.eps)
    p = p / p.sum(axis=-1, keepdims=True)
    freq = np.stack([np.bincount(idx[..., h].reshape(-1).numpy(), minlength=K) for h in range(H)]) / n
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-9), (freq, p)


# ------------------------------------------------------------------ modules


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_torch_batch_norm_matches_jax(rng, train):
    """``nn.BatchNorm1d(affine=False)`` as JAX computes it: the biased batch
    variance over every frame normalizes, the Bessel-corrected one moves
    the running variance with momentum 0.1; ``eval()`` reads the running
    statistics. The input gradient goes through the batch statistics."""
    x = (rng.normal(size=(3, 11, 6)) * 2.0 + 0.5).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    jbn = j_modules.TorchBatchNorm()
    v = _np_tree(jbn.init(jax.random.PRNGKey(0), x))
    v["batch_stats"] = {"mean": rng.normal(size=6).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, size=6).astype(np.float32)}

    def jloss(x):
        y, mut = jbn.apply(v, x, use_running_average=not train, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut)

    (_, (want, mut)), want_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    port = t_modules.TorchBatchNorm(6).train(train)
    with torch.no_grad():
        port.running_mean.copy_(_t(v["batch_stats"]["mean"]))
        port.running_var.copy_(_t(v["batch_stats"]["var"]))
    tx = _t(x).requires_grad_(True)
    got = port(tx)
    (got * _t(w)).sum().backward()
    _close(got.detach(), want, BN_TOL)
    _close(tx.grad, want_grad, BN_TOL)
    stats = mut["batch_stats"] if train else v["batch_stats"]
    _close(port.running_mean, stats["mean"], STATS_TOL)
    _close(port.running_var, stats["var"], STATS_TOL)
    if train:
        assert not np.allclose(stats["var"], v["batch_stats"]["var"])


def _mask(lengths, T):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


def test_res_stack_with_global_conditioning_matches_jax(rng):
    C, gin, B, T = 8, 5, 2, 13
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    g = rng.normal(size=(B, 1, gin)).astype(np.float32)
    mask = _mask([13, 8], T)
    jmod = j_modules.ResStack(hidden_channels=C, kernel_size=3, dilation_rate=2, n_layers=3, gin_channels=gin)
    params = _gains(_np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(1), x, mask, g))["params"], rng)
    with HIGHEST:
        want = jax.jit(jmod.apply)({"params": params}, x, mask, g)
        without = jax.jit(jmod.apply)({"params": params}, x, mask)
    port = t_modules.ResStack(C, 3, 2, 3, gin_channels=gin).eval()
    W.load_numpy_state(port, W.res_stack_from_jax(params))
    with torch.inference_mode():
        got = port(_t(x), _t(mask), _t(g))
        got_without = port(_t(x), _t(mask))
    _close(got, want, OUT_TOL)
    _close(got_without, without, OUT_TOL)
    assert not np.allclose(np.asarray(want), np.asarray(without))
    _same_tree(W.res_stack_to_jax(W.state_dict_numpy(port)), params)


def test_encoder_matches_jax(rng):
    B, T = 2, 12
    x = rng.normal(size=(B, T, 6)).astype(np.float32)
    mask = _mask([12, 5], T)
    jmod = j_modules.Encoder(in_channels=6, out_channels=4, hidden_channels=8, kernel_size=5, n_layers=2)
    params = _gains(_np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(2), x, mask))["params"], rng)
    with HIGHEST:
        want = jax.jit(jmod.apply)({"params": params}, x, mask)
    port = t_modules.Encoder(6, 4, 8, kernel_size=5, n_layers=2).eval()
    W.load_numpy_state(port, W.encoder_from_jax(params))
    with torch.inference_mode():
        got = port(_t(x), _t(mask))
    _close(got, want, OUT_TOL)
    _same_tree(W.encoder_to_jax(W.state_dict_numpy(port)), params)


@pytest.mark.parametrize("kernel", [2, 4], ids=["k2", "k4"])
def test_even_kernel_fft_blocks_and_duration_predictor_match_jax(rng, kernel):
    """flax's ``"SAME"`` pads an even kernel (k - 1) // 2 before and k // 2
    after; the port's convs pad the same frames."""
    B, T, M = 2, 10, 16
    lengths = np.array([10, 6])
    pos = ((np.arange(T)[None] + 1) * (np.arange(T)[None] < lengths[:, None])).astype(np.int32)
    x = rng.normal(size=(B, T, M)).astype(np.float32)
    cfg = dict(max_seq_len=32, n_layers=2, n_head=2, d_k=8, d_v=8, d_model=M, d_inner=32, fft_conv1d_kernel=kernel)
    jfft = JFFTBlocks(**cfg)
    fparams = _np_tree(jax.jit(jfft.init)(jax.random.PRNGKey(4), x, pos))["params"]
    jdp = JDurationPredictor(filter_size=8, kernel=kernel)
    non_pad = (pos != 0)[..., None].astype(np.float32)
    dparams = _np_tree(jax.jit(jdp.init)(jax.random.PRNGKey(5), x, non_pad))["params"]
    with HIGHEST:
        want, _ = jax.jit(jfft.apply)({"params": fparams}, x, pos)
        want_dur = jax.jit(jdp.apply)({"params": dparams}, x, non_pad)
    fft = t_transformer.FFTBlocks(**cfg).eval()
    W.load_numpy_state(fft, W.fft_blocks_from_jax(fparams))
    dp = t_transformer.DurationPredictor(M, 8, kernel).eval()
    W.load_numpy_state(dp, W.duration_predictor_from_jax(dparams))
    with torch.inference_mode():
        got, _ = fft(_t(x), _t(pos, torch.long))
        got_dur = dp(_t(x), _t(non_pad))
    _close(got, want, OUT_TOL)
    _close(got_dur, want_dur, OUT_TOL)


@pytest.mark.parametrize("u", [1, 2, 3, 4, 5])
def test_upsampler_transposed_conv_matches_jax(rng, u):
    """The learned upsampler's shapes (k = 2u for even u, else 2u + 1,
    padding (k - u) // 2): ``F.conv_transpose1d`` against JAX's lhs-dilated
    correlation, exactly u output frames a frame."""
    from msmctts_tpu.ops.convs import WNConvTranspose1d as JUp
    from msmctts_tpu_torch.ops.convs import WNConvTranspose1d as TUp

    k = 2 * u if u % 2 == 0 else 2 * u + 1
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    jmod = JUp(16, k, u, (k - u) // 2)
    params = _gains(_np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(u), x))["params"], rng)
    with HIGHEST:
        want = jax.jit(jmod.apply)({"params": params}, x)
    port = TUp(16, 16, k, u, (k - u) // 2).eval()
    W.load_numpy_state(port, {k.split(".", 1)[1]: v for k, v in W.wn_conv_transpose1d_from_jax(params, "up").items()})
    with torch.inference_mode():
        got = port(_t(x).transpose(1, 2)).transpose(1, 2)
    assert tuple(got.shape) == np.asarray(want).shape == (2, 7 * u, 16)
    _close(got, want, OUT_TOL)


# --------------------------------------------------------------- autoencoder


def _options_config(upsampling, norm=True):
    node = tiny_ae_config("/unused").to_dict()["task"]["autoencoder"]
    node["quantizer_config"].update(upsampling=upsampling, norm=norm)
    return {k: v for k, v in node.items() if not k.startswith("_")}


def _ae_batch(rng):
    mel = rng.normal(size=(3, 16, MEL_DIM)).astype(np.float32)
    return mel, np.array([16, 11, 6], np.int32)


@pytest.fixture(scope="module", params=["mapping", "residual"])
def ae_pair(request):
    """The tiny autoencoder with learned upsampling and ``norm: True``,
    initialised in JAX (random gains, running statistics away from 0 / 1),
    and the port's copy through ``msmc_vqgan_from_jax``."""
    rng = np.random.default_rng(11)
    kw = _options_config(request.param)
    jae = JAutoencoder(**kw)
    mel, lengths = _ae_batch(rng)
    v = _np_tree(jax.jit(lambda k: jae.init({"params": k, "dropout": k}, mel, lengths))(jax.random.PRNGKey(0)))
    _gains(v["params"], rng)
    for node in v["batch_stats"]["quantizer"].values():
        node["mean"] = rng.normal(scale=0.2, size=node["mean"].shape).astype(np.float32)
        node["var"] = rng.uniform(0.5, 1.5, size=node["var"].shape).astype(np.float32)
    port = t_msmc.MSMCVQGAN(**kw).eval()
    W.load_numpy_state(port, W.msmc_vqgan_from_jax(v))
    return dict(mode=request.param, kw=kw, jae=jae, v=v, port=port, mel=mel, lengths=lengths)


def test_learned_upsampling_analysis_synthesis_matches_jax(ae_pair):
    jae, v, port, mel, lengths = (ae_pair[k] for k in ("jae", "v", "port", "mel", "lengths"))
    assert port.quantizer.transposed_conv is not None and len(port.quantizer.preprocessor[0]) == 4
    with HIGHEST:
        want = jax.jit(lambda v, m, l: jae.apply(v, m, l))(v, mel, lengths)
    with torch.inference_mode():
        got = port(_t(mel), _t(lengths, torch.long))
    for g, w in zip(got["encoder_indices"], want["encoder_indices"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _close(got["decoder_outputs"], want["decoder_outputs"], WAV_TOL)
    _close(got["mel_outputs"], want["mel_outputs"], OUT_TOL)


def test_learned_upsampling_synthesis_matches_jax(ae_pair):
    """``synthesis`` from perturbed codewords: the re-quantization's indices
    equal, the features and the waveform within tolerance."""
    jae, v, port, mel, lengths = (ae_pair[k] for k in ("jae", "v", "port", "mel", "lengths"))
    rng = np.random.default_rng(5)
    with HIGHEST:
        q = jax.jit(lambda v, m, l: jae.apply(v, m, l, method="analysis"))(v, mel, lengths)
    outs = [np.asarray(o) + rng.normal(scale=0.05, size=np.shape(o)).astype(np.float32) for o in q["quantizer_outputs"]]
    lens = [np.asarray(n) for n in q["quantizer_lengths"]]
    with HIGHEST:
        want = jax.jit(lambda v, o, n: jae.apply(v, o, n, method="synthesis"))(v, outs, lens)
        want_feats = jax.jit(lambda v, o, n: jae.apply(v, o, n, method="synthesis_features"))(v, outs, lens)
        want_q = jax.jit(lambda v, o, n: jae.apply(
            v, list(zip(o, n)), method=lambda m, s: m.quantizer(s, from_encoder=False)))(v, outs, lens)
    with torch.inference_mode():
        got = port.synthesis([_t(o) for o in outs], [_t(n, torch.long) for n in lens])
        got_feats = port.synthesis_features([_t(o) for o in outs], [_t(n, torch.long) for n in lens])
        got_q = port.quantizer([(_t(o), _t(n, torch.long)) for o, n in zip(outs, lens)], from_encoder=False)
    for g, w in zip(got_q["quantizer_indices"], want_q["quantizer_indices"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _close(got_q["residual_output"], want_q["residual_output"], OUT_TOL)
    _close(got_feats, want_feats, OUT_TOL)
    _close(got, want, WAV_TOL)


def test_learned_upsampling_training_forward_matches_jax(ae_pair):
    """One training forward (dropout 0): the batch statistics move as JAX's
    ``batch_stats`` do, the codebook as its ``codebook``, the prior losses
    and the indices are JAX's."""
    kw = dict(ae_pair["kw"])
    kw["quantizer_config"] = dict(kw["quantizer_config"], dropout=0.0,
                                  prior_config=dict(kw["quantizer_config"]["prior_config"], p_dropout=0.0))
    for name in ("encoder_config", "frame_decoder_config"):
        kw[name] = dict(kw[name], dropout=0.0, attn_dropout=0.0)
    jae = JAutoencoder(**kw)
    v, mel, lengths = ae_pair["v"], ae_pair["mel"], ae_pair["lengths"]
    with HIGHEST:
        want, mut = jax.jit(lambda v, m, l: jae.apply(v, m, l, warmup=True, deterministic=False,
                                                      mutable=["codebook", "batch_stats"]))(v, mel, lengths)
    port = t_msmc.MSMCVQGAN(**kw)
    W.load_numpy_state(port, W.msmc_vqgan_from_jax(v))
    port.train()
    got = port(_t(mel), _t(lengths, torch.long), warmup=True)
    for g, w in zip(got["encoder_indices"], want["encoder_indices"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got["decoder_diffs"]["total_loss"].detach()) == pytest.approx(float(want["decoder_diffs"]["total_loss"]), rel=1e-5)
    state = W.msmc_vqgan_to_jax(W.state_dict_numpy(port))
    for stage, node in mut["batch_stats"]["quantizer"].items():
        for key in ("mean", "var"):
            _close(state["batch_stats"]["quantizer"][stage][key], node[key], STATS_TOL)
            assert not np.allclose(node[key], v["batch_stats"]["quantizer"][stage][key])
    for stage, node in mut["codebook"]["quantizer"].items():
        for key in ("embed", "cluster_size", "embed_avg"):
            _close(state["codebook"]["quantizer"][stage][key], node[key], 2e-5)


def test_learned_upsampling_converters_round_trip_through_jax(ae_pair):
    """The port's state through ``msmc_vqgan_to_jax`` (``up_i``,
    ``batch_stats.quantizer.prenorm_i``) drives JAX's ``apply`` to the
    port's output, and ``msmc_vqgan_from_jax`` gives it back bit for bit."""
    port, jae, mel, lengths = ae_pair["port"], ae_pair["jae"], ae_pair["mel"], ae_pair["lengths"]
    sd = W.state_dict_numpy(port)
    tree = W.msmc_vqgan_to_jax(sd)
    assert sorted(tree["batch_stats"]["quantizer"]) == ["prenorm_0", "prenorm_1"]
    assert {"up_0", "up_1"} <= set(tree["params"]["quantizer"])
    back = W.msmc_vqgan_from_jax(tree)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    _same_tree(tree["batch_stats"], ae_pair["v"]["batch_stats"])
    with HIGHEST:
        want = jax.jit(lambda v, m, l: jae.apply(v, m, l))(tree, mel, lengths)
    with torch.inference_mode():
        got = port(_t(mel), _t(lengths, torch.long))
    _close(got["decoder_outputs"], want["decoder_outputs"], WAV_TOL)


@pytest.mark.parametrize("upsampling", ["repeat", "mapping", "residual"])
def test_padding_reach_walks_the_residual_chain(upsampling):
    """The reach in output frames: the prior predictor's radius + 1 at
    stage 1, each learned upsampler's padding at its output rate."""
    kw = _options_config(upsampling, norm=False)
    kw["encoder_config"] = dict(kw["encoder_config"], downsample_scales=[1, 4])
    q = t_msmc.MSMCVQGAN(**kw).quantizer  # upsample_scales [4, 1]; prior kernel 3, one layer
    want = {"repeat": 2, "mapping": 2 + 2 + 1, "residual": 2 + 2 + 1}[upsampling]  # k=8, p=2 at u=4; k=3, p=1 at u=1
    assert q.padding_reach_frames() == want


# ------------------------------------------------------------------ serving

# The serving pair: a residual upsampler at u = 32 (k = 64, padding 16) reaches
# 17 frames into the padding, beyond the tiny decoder's receptive field (13),
# which was the margin before the upsamplers' reach was counted.
UP = 32
OLD_MARGIN = 13


@pytest.fixture(scope="module")
def upsampling_pair(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("options_pair"))
    rng = np.random.default_rng(0)
    ae_cfg = tiny_ae_config(d).to_dict()
    node = ae_cfg["task"]["autoencoder"]
    node["encoder_config"]["downsample_scales"] = [1, UP]
    node["encoder_config"]["max_seq_len"] = 256
    node["frame_decoder_config"]["max_seq_len"] = 256
    node["quantizer_config"]["upsampling"] = "residual"
    jae = JAutoencoder(**{k: v for k, v in node.items() if not k.startswith("_")})
    mel = np.zeros((1, UP, MEL_DIM), np.float32)
    key = jax.random.PRNGKey(0)
    av = _np_tree(jax.jit(lambda k: jae.init({"params": k, "dropout": k}, mel, np.array([UP], np.int32)))(key))
    ae_path = os.path.join(d, "ae.ckpt")
    save_checkpoint(ae_path, {"params": {"autoencoder": _gains(av["params"], rng)}, "codebook": av["codebook"]}, 1,
                    ae_cfg)
    am_cfg = tiny_am_config(d, ae_path).to_dict()
    pnode = am_cfg["task"]["predictor"]
    pnode["n_pred_scale"] = [UP, 1]
    pnode["decoder_config"]["max_seq_len"] = 256
    pred = JPredictor(**{k: v for k, v in pnode.items() if not k.startswith("_")})
    text = np.ones((1, 8, 2), np.int32)
    pv = jax.jit(lambda k: pred.init(k, text, np.array([8], np.int32), dur=np.ones((1, 8), np.float32),
                                     max_frames=UP))(key)
    pparams = JPredictor.bias_durations(jax.device_get(pv)["params"], 3.0)
    am_path = os.path.join(d, "am.ckpt")
    save_checkpoint(am_path, {"params": {"predictor": pparams}}, 1, am_cfg)
    return am_path


def _port_task(path):
    ck = t_load_checkpoint(path)
    task = t_build_task(TConfig(ck["config"]), device="cpu")
    task.load_variables(ck["state"])
    task.pre_infer()
    return task


def _texts_by_total(task, Lt=48, B=4, seed=0):
    rng = np.random.default_rng(seed)
    found = {}
    for n in range(4, Lt + 1):
        for _ in range(6):
            t = np.stack([rng.integers(1, 20, n), rng.integers(0, 5, n)], -1).astype(np.int32)
            text = np.zeros((B, Lt, 2), np.int32)
            text[:, :n] = t
            total = int(task._predict_phase1({"text": text, "text_length": np.full(B, n)})["total"][0])
            found.setdefault(total, " ".join(f"{a}_{b}" for a, b in t))
    return found


def _alone_and_shared(port, texts):
    kw = dict(sample_rate=1600, batch_size=4, text_length=48, max_frames=256, stream_chunk_frames=8)
    eng = BatchingEngine(port, window_ms=0.0, **kw).start(warmup={"text_lengths": [48]})
    try:
        alone = [eng.synthesize(t, timeout=120) for t in texts]
    finally:
        eng.stop()
    eng = BatchingEngine(port, window_ms=500.0, **kw).start()
    try:
        shared = [None] * len(texts)

        def run(i):
            shared[i] = eng.synthesize(texts[i], timeout=120)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(texts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert eng.snapshot()["batches"] == 1 and all(r is not None for r in shared)
    finally:
        eng.stop()
    return alone, shared


def test_engine_decodes_a_request_alike_alone_and_in_a_shared_batch_over_residual_upsampling(upsampling_pair,
                                                                                             monkeypatch):
    """A request whose frames plus the decoder's reach fill its bucket
    exactly, beside longer ones: with the margin that counts the learned
    upsampler's reach it decodes as it does alone; with the decoder's reach
    alone as the margin, the upsampler's conv reads the bucket's end into
    its last frames and the frame decoder's attention spreads that over the
    utterance."""
    port = _port_task(upsampling_pair)
    assert port.padding_reach_frames() == 19 > OLD_MARGIN  # (16 at u = 32 + 1 + 1) * 1 + 1 at u = 1
    by_total = _texts_by_total(port)
    near = 64 - OLD_MARGIN
    texts = [by_total[near], by_total[max(by_total)], by_total[min(by_total)]]
    assert bucket_length(max(by_total) + 19, FRAME_BUCKETS) > 64
    alone, shared = _alone_and_shared(port, texts)
    assert alone[0].shape[0] == near * FRAMESHIFT
    for got, want in zip(shared, alone):
        assert got.shape == want.shape and np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got, want, atol=SOLO_TOL, rtol=0)

    monkeypatch.setattr(port, "padding_reach_frames", lambda: OLD_MARGIN)
    alone, shared = _alone_and_shared(port, texts)
    assert port.frame_margin == OLD_MARGIN
    assert np.abs(shared[0] - alone[0]).max() > 100 * SOLO_TOL
