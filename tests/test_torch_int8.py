"""The port's int8 HiFi-GAN decoder (``msmctts_tpu_torch/ops/int8_generator.py``
and its wiring into the task, streaming, serving and the CLIs) against
msmctts_tpu on the CPU, at the shapes of ``tests/test_int8_generator.py``
and on the tiny AE + AM pair of ``test_torch_slice.tiny_pair``.

Tolerances.
  * int8 convs on equal int8 operands: bit-equal int32 (both stacks sum
    integers exactly).
  * quantized weights from equal folded kernels: equal. From each stack's
    own weight-norm fold (which sums its squares in another order): ``w_q``
    equal but for entries one step apart, at most 0.1 % of a site (0
    observed), scales within 4 fp32 ulps, 5e-7 relative (observed 2.8e-7),
    other leaves 1e-6.
  * calibration state (amax, SmoothQuant vectors, static scales): 1e-6
    relative (observed: equal).
  * the first site's int8 codes: bit-equal; every waveform: relative L2
    1e-3 of JAX's int8 waveform on the same weights and inputs (observed
    3.6e-7 for the generator: the int32 sums and the elementwise dequant are
    equal, conv_post's fp32 sum order is not);
  * ``predict`` end to end: the decoder's fp32 inputs agree to 1e-5
    (observed 9e-7), and a difference at that level can still move an
    activation across a rounding boundary, which changes its code by one
    step; one such flip put the int8 waveform 2.8e-3 (relative L2) from
    JAX's, so ``predict`` and ``predict_stream`` are held to 1e-2 end to end
    and, on the port's own decoder inputs, to the 1e-3 above (observed 1e-7).
  * int8 against fp32, JAX's own bounds: generator 0.05, task 0.25.
  * a request the serving engine decodes beside others against the same
    request alone: 1e-6 absolute (observed: equal).
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import msmctts_tpu.ops.int8_generator as J
from msmctts_tpu.config import Config
from msmctts_tpu.data.loader import finite_loader as j_finite_loader
from msmctts_tpu.models.hifigan import HifiGANGenerator as JGenerator
from msmctts_tpu.tasks import build_task
from msmctts_tpu.training.base_trainer import build_dataset_from_config as j_build_dataset
from msmctts_tpu.utils.checkpoint import load_checkpoint
import msmctts_tpu_torch.ops.int8_generator as T
from msmctts_tpu_torch import infer as t_infer
from msmctts_tpu_torch import serve as t_serve
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.data.datasets import FRAME_BUCKETS, bucket_length
from msmctts_tpu_torch.models.hifigan import HifiGANGenerator as TGenerator
from msmctts_tpu_torch.serving import BatchingEngine
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint as t_load_checkpoint
from tests.test_torch_slice import tiny_pair  # noqa: F401  (module fixture)
from tests.tiny import FRAMESHIFT, MEL_DIM

torch.set_num_threads(2)

CFG = dict(
    upsample_rates=[2, 2],
    upsample_kernel_sizes=[4, 4],
    upsample_initial_channel=64,
    resblock_kernel_sizes=[3, 7],
    resblock_dilation_sizes=[[1, 3], [1, 3]],
)
WAV_REL = 1e-3  # int8 waveform, port vs JAX (relative L2)
GEN_BOUND = 0.05  # int8 vs fp32, the generator (test_int8_generator.py)
TASK_BOUND = 0.25  # int8 vs fp32, the task (test_int8_generator.py)
STATE_RTOL = 1e-6
FEAT_TOL = 1e-5  # the decoder's fp32 inputs, port vs JAX
FLIP_REL = 1e-2  # int8 waveform end to end through predict, port vs JAX (see below)
SOLO_TOL = 1e-6  # a request served in a shared batch vs the same request alone (observed: equal)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.fixture(scope="module")
def gen():
    """A flax HifiGANGenerator at the JAX tests' widths, and the port's with
    its weights."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 24, 16)).astype(np.float32)
    g = JGenerator(num_mels=16, **CFG)
    v = jax.device_get(g.init(jax.random.PRNGKey(0), x))
    port = TGenerator(num_mels=16, **CFG).eval()
    W.load_numpy_state(port, W.generator_from_jax(v["params"]))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(g.apply(v, x), np.float32)
    return dict(x=x, params=v["params"], port=port, fp32=want)


def _jax(fn):
    with jax.default_matmul_precision("highest"):
        return fn()


# ------------------------------------------------------------- the convs


@pytest.mark.parametrize("k,d", [(3, 1), (3, 5), (7, 3), (11, 1)])
def test_int8_conv1d_bit_equal_to_jax(k, d):
    rng = np.random.default_rng(k * 10 + d)
    xq = rng.integers(-127, 128, size=(2, 37, 8)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(k, 8, 12)).astype(np.int8)
    want = np.asarray(J.int8_conv1d(jnp.asarray(xq), jnp.asarray(wq), (k - 1) // 2 * d, d))
    got = T.int8_conv1d(torch.from_numpy(xq), torch.from_numpy(wq), (k - 1) // 2 * d, d)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,u", [(12, 6), (11, 5), (4, 2), (6, 2)])
def test_int8_conv_transpose1d_bit_equal_to_jax(k, u):
    rng = np.random.default_rng(k * 10 + u)
    p = (k - u) // 2
    xq = rng.integers(-127, 128, size=(2, 19, 6)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(k, 6, 10)).astype(np.int8)
    want = np.asarray(J.int8_conv_transpose1d(jnp.asarray(xq), jnp.asarray(wq), u, p))
    got = T.int8_conv_transpose1d(torch.from_numpy(xq), torch.from_numpy(wq), u, p)
    assert got.shape == (2, 19 * u, 10)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,k,d,length,c_in,c_out", [(2, 3, 1, 37, 8, 12), (1, 7, 3, 5, 6, 10), (4, 11, 5, 64, 32, 24),
                                                 (3, 12, 1, 20, 16, 8)],
                         ids=["ragged-widths", "few-rows", "csmsc-like", "transposed-like"])
def test_the_cards_im2col_product_equals_the_plain_sums(B, k, d, length, c_in, c_out):
    """The card's formulation (the batch's padded rows end to end, a strided
    im2col, zero padding to cuBLASLt's shapes, one ``torch._int_mm``) run on
    the CPU, where ``torch._int_mm`` also exists, against the plain per-tap
    sums."""
    if not hasattr(torch, "_int_mm"):
        pytest.skip("this torch has no _int_mm")
    rng = np.random.default_rng(length)
    xq = torch.from_numpy(rng.integers(-127, 128, size=(B, length, c_in)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, size=(k, c_in, c_out)).astype(np.int8))
    before = T.LAUNCHES["int8_conv1d"]
    got = T._int8_conv1d_im2col(xq, wq, (k - 1) // 2 * d, d)
    assert T.LAUNCHES["int8_conv1d"] == before + 1
    want = T.int8_conv1d_plain(xq, wq, (k - 1) // 2 * d, d)
    assert got.shape == want.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_int8_conv_refuses_other_types_and_a_bad_transpose_geometry():
    x = torch.zeros((1, 4, 8), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        T.int8_conv1d(x.float(), torch.zeros((3, 8, 8), dtype=torch.int8), 1)
    with pytest.raises(ValueError, match="2 \\* padding"):
        T.int8_conv_transpose1d(x, torch.zeros((5, 8, 8), dtype=torch.int8), 2, 2)


# ------------------------------------------------------------- weights


def _tree_pairs(a, b, prefix=""):
    for k in a:
        if isinstance(a[k], dict):
            yield from _tree_pairs(a[k], b[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", a[k], b[k]


def _hold_qparams(got, want):
    assert sorted(got) == sorted(want)
    for name, a, b in _tree_pairs(got, want):
        if b is None:
            assert a is None, name
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if b.dtype == np.int8:
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).sum() <= 0.001 * b.size, (name, int((diff > 0).sum()))
        else:
            np.testing.assert_allclose(a, b, rtol=5e-7 if name.endswith("scale") else 1e-6, atol=0, err_msg=name)


def test_quantization_of_equal_folded_kernels_is_equal(gen):
    folded = J._fold_generator_params(gen["params"], CFG)
    smooth = {site: np.linspace(0.5, 2.0, w.shape[-2]).astype(np.float32) for site, (w, _) in folded.items()}
    for kw in ({}, {"smooth": smooth}, {"float_sites": ("up_1",)}):
        want = J._quantize_folded(folded, CFG, **kw)
        got = T._quantize_folded(folded, CFG, **kw)
        for name, a, b in _tree_pairs(got, want):
            if b is None:
                assert a is None, name
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
                assert np.asarray(a).dtype == np.asarray(b).dtype, name


def test_quantize_generator_params_matches_jax(gen):
    want = J.quantize_generator_params(gen["params"], CFG)
    got = T.quantize_generator_params(gen["port"], CFG)
    _hold_qparams(got, want)
    assert got["conv_pre"]["w_q"].dtype == np.int8 and got["conv_pre"]["scale"].shape == (64,)
    assert "w" in got["conv_post"] and "w_q" not in got["conv_post"]


def test_float_sites_keep_float_kernels_as_in_jax(gen):
    sites = ("up_0", "resblock_0_")
    want = J.quantize_generator_params(gen["params"], CFG, float_sites=sites)
    got = T.quantize_generator_params(gen["port"], CFG, float_sites=sites)
    _hold_qparams(got, want)
    assert "w" in got["up_0"] and "w" in got["resblock_0_0"]["conv1_0"] and "w_q" in got["up_1"]
    x = torch.from_numpy(gen["x"])
    hybrid = T.int8_generator_apply(T.qparams_to(got, "cpu"), x, CFG).numpy()
    assert _rel(hybrid, _jax(lambda: J.int8_generator_apply(want, gen["x"], CFG, dtype=jnp.float32))) < WAV_REL
    assert _rel(hybrid, gen["fp32"]) < GEN_BOUND
    # every site float: the port's own fp32 generator, up to the fold's rounding
    every = T.quantize_generator_params(gen["port"], CFG, float_sites=("conv_pre", "up_", "resblock_"))
    with torch.no_grad():
        fp32 = gen["port"](x).numpy()
    assert _rel(T.int8_generator_apply(T.qparams_to(every, "cpu"), x, CFG).numpy(), fp32) < 1e-5


def test_build_smoothing_matches_jax(gen):
    rng = np.random.default_rng(5)
    folded_j = J._fold_generator_params(gen["params"], CFG)
    folded_t = T._fold_generator_params(gen["port"])
    assert sorted(folded_j) == sorted(folded_t)
    amax = {site: rng.uniform(0.01, 10.0, size=w.shape[-2]).astype(np.float32) for site, (w, _) in folded_j.items()}
    for alpha in (1.0, 0.5):
        want = J.build_smoothing(folded_j, amax, alpha)
        got = T.build_smoothing(folded_t, amax, alpha)
        assert sorted(got) == sorted(want) and "conv_post" not in got
        for site in want:
            np.testing.assert_allclose(got[site], want[site], rtol=STATE_RTOL, err_msg=site)


# ------------------------------------------------------------ the graph


def test_int8_generator_apply_matches_jax(gen):
    x = gen["x"]
    qp_j = J.quantize_generator_params(gen["params"], CFG)
    qp_t = T.qparams_to(T.quantize_generator_params(gen["port"], CFG), "cpu")
    # the first site's codes from equal inputs
    qj, sj = J._ActQuant()(jnp.asarray(x), "conv_pre")
    qt, st = T._ActQuant()(torch.from_numpy(x), "conv_pre")
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert float(st) == float(sj)
    want = _jax(lambda: np.asarray(J.int8_generator_apply(qp_j, x, CFG, dtype=jnp.float32)))
    got = T.int8_generator_apply(qp_t, torch.from_numpy(x), CFG)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < WAV_REL
    assert _rel(got.numpy(), gen["fp32"]) < GEN_BOUND


def test_static_scales_track_dynamic_as_in_jax(gen):
    x = gen["x"]
    qp_j = J.quantize_generator_params(gen["params"], CFG)
    qp_t = T.qparams_to(T.quantize_generator_params(gen["port"], CFG), "cpu")
    want = _jax(lambda: J.calibrate_act_scales(qp_j, [x], CFG, headroom=1.0))
    got = T.calibrate_act_scales(qp_t, [torch.from_numpy(x)], CFG, headroom=1.0)
    assert sorted(got) == sorted(want) and "conv_post" not in got
    for site in want:
        assert got[site] == pytest.approx(want[site], rel=STATE_RTOL), site
    dyn = T.int8_generator_apply(qp_t, torch.from_numpy(x), CFG).numpy()
    stat = T.int8_generator_apply(qp_t, torch.from_numpy(x), CFG, act_scales=got).numpy()
    assert _rel(stat, dyn) < 0.05
    jstat = _jax(lambda: np.asarray(J.int8_generator_apply(qp_j, x, CFG, dtype=jnp.float32, act_scales=want)))
    assert _rel(stat, jstat) < WAV_REL


def test_int8_decoder_calibration_state_matches_jax(gen):
    x = gen["x"]
    jd = J.Int8Decoder(gen["params"], CFG, dtype=jnp.float32)
    _jax(lambda: jd.calibrate(x))
    td = T.Int8Decoder(gen["port"], CFG)
    with pytest.raises(RuntimeError, match="calibrate"):
        td.apply(torch.from_numpy(x))
    td.calibrate(torch.from_numpy(x))
    assert sorted(td.scales) == sorted(jd.scales) and "conv_post" not in td.scales
    for site in jd.scales:
        assert td.scales[site] == pytest.approx(jd.scales[site], rel=STATE_RTOL), site
    _hold_qparams(td.qparams, jd.qparams)
    assert td.qparams["conv_pre"]["s_in"].shape == (16,) and np.all(td.qparams["conv_pre"]["s_in"] > 0)
    got = td.apply(torch.from_numpy(x)).numpy()
    want = _jax(lambda: np.asarray(jd.apply(x)))
    assert _rel(got, want) < WAV_REL and _rel(got, gen["fp32"]) < GEN_BOUND
    # re-calibration observes the raw ranges again
    first = dict(td.scales)
    td.calibrate(torch.from_numpy(x * 3.0))
    assert set(td.scales) == set(first) and td.scales["conv_pre"] > first["conv_pre"]


def test_smoothquant_ones_fold_is_identity_and_the_fold_helps(gen):
    x = torch.from_numpy(gen["x"])
    folded = T._fold_generator_params(gen["port"])
    ones = {site: np.ones(w.shape[-2], np.float32) for site, (w, _) in folded.items() if site != "conv_post"}
    plain = T.int8_generator_apply(T.qparams_to(T.quantize_generator_params(gen["port"], CFG), "cpu"), x, CFG)
    ones_qp = T.qparams_to(T.quantize_generator_params(gen["port"], CFG, smooth=ones), "cpu")
    with_ones = T.int8_generator_apply(ones_qp, x, CFG)
    assert torch.equal(plain, with_ones)
    # channels four decades apart: the fold brings the int8 decode closer to fp32
    skew = torch.from_numpy(np.logspace(-2, 2, 16).astype(np.float32))
    xs = x * skew
    with torch.no_grad():
        want = gen["port"](xs).numpy()
    rels = {}
    for alpha in (None, 1.0):
        dec = T.Int8Decoder(gen["port"], CFG, headroom=1.0, smooth_alpha=alpha)
        dec.calibrate(xs)
        rels[alpha] = _rel(dec.apply(xs).numpy(), want)
    assert rels[1.0] < rels[None] and rels[1.0] < GEN_BOUND, rels


# ------------------------------------------------------------- the task


def _jax_task(path):
    ck = load_checkpoint(path)
    task = build_task(Config(ck["config"]), mode="infer")
    task.load_variables(ck["state"])
    task.pre_infer()
    return task


def _port_task(path):
    ck = t_load_checkpoint(path)
    task = t_build_task(TConfig(ck["config"]), device="cpu")
    task.load_variables(ck["state"])
    task.pre_infer()
    return task


def _ae_batch(seed=3):
    rng = np.random.default_rng(seed)
    return {"mel": rng.normal(size=(2, 16, MEL_DIM)).astype(np.float32), "mel_length": np.array([16, 12], np.int32)}


def _tts_batch(forced=True, seed=3):
    rng = np.random.default_rng(seed)
    B, Lt = 3, 16
    text_length = np.array([12, 7, 16])
    valid = np.arange(Lt)[None] < text_length[:, None]
    text = np.stack([rng.integers(1, 20, (B, Lt)), rng.integers(0, 5, (B, Lt))], -1) * valid[..., None]
    batch = {"text": text.astype(np.int32), "text_length": text_length.astype(np.int32)}
    if forced:
        batch["dur"] = (rng.integers(2, 6, (B, Lt)) * valid).astype(np.float32)
    return batch


def _hold_wavs(got, want, lengths, rel=WAV_REL):
    assert len(got) == len(want)
    for a, b, n in zip(got, want, lengths):
        assert a.shape == (int(n) * FRAMESHIFT,)
        assert np.all(np.isfinite(a))
        assert _rel(a, np.asarray(b)) < rel


@pytest.fixture(scope="module")
def ae_tasks(tiny_pair):
    ck = load_checkpoint(tiny_pair["ae"])
    jtask = build_task(Config(ck["config"]), mode="infer")
    jtask.load_variables(ck["state"])
    return jtask, _port_task(tiny_pair["ae"])


def test_task_analysis_synthesis_int8_matches_jax(ae_tasks):
    jtask, port = ae_tasks
    batch = _ae_batch()
    fp32 = port.analysis_synthesis(batch)
    jtask.int8_decoder = port.int8_decoder = True
    try:
        want = _jax(lambda: jtask.analysis_synthesis(batch))
        got = port.analysis_synthesis(batch)
    finally:
        jtask.int8_decoder = port.int8_decoder = False
    assert port._int8_state is not None and port._int8_state.scales  # first-batch calibration ran
    for site, s in jtask._jit_cache["int8"].scales.items():
        assert port._int8_state.scales[site] == pytest.approx(s, rel=STATE_RTOL), site
    _hold_wavs(got["wav"], want["wav"], batch["mel_length"])
    for a, b in zip(got["wav"], fp32["wav"]):
        assert _rel(a, b) < TASK_BOUND
    assert ("ae8", 16) in port.shapes


@pytest.fixture(scope="module")
def tts_tasks(tiny_pair):
    jtask, port = _jax_task(tiny_pair["am"]), _port_task(tiny_pair["am"])
    jtask.int8_decoder = port.int8_decoder = True
    return jtask, port


def _jax_int8_decode(jtask, feats):
    """JAX's int8 serving graph (jitted, static scales as constants) on the
    given decoder inputs."""
    i8 = jtask._jit_cache["int8"]
    fn = jax.jit(lambda qp, f: J.int8_generator_apply(qp, f, i8.decoder_config, dtype=jnp.float32,
                                                      act_scales=i8.scales))
    return _jax(lambda: np.asarray(fn(i8.qparams, np.asarray(feats))[..., 0]))


def _jax_features(jtask, batch):
    def run():
        p1 = jtask._predict_phase1(batch)
        _, feats = jtask._syn_feat_fn(p1["Lt"], p1["max_frames"])(
            jtask.variables["predictor"], jtask.variables["autoencoder"], p1["text"], p1["text_length"],
            p1["durations_dev"].astype(jnp.float32), p1["codebooks"], max_frames=p1["max_frames"])
        return np.asarray(feats)

    return _jax(run)


def test_predict_int8_matches_jax(tts_tasks):
    """The decoder's inputs agree to fp32 rounding (FEAT_TOL); on equal inputs
    the int8 decodes agree to WAV_REL; end to end, a rounding-level input
    difference can move a code across a rounding boundary, one step, so the
    waveforms are held to FLIP_REL."""
    jtask, port = tts_tasks
    for forced in (True, False):  # the first batch calibrates both decoders
        batch = _tts_batch(forced)
        want = _jax(lambda: jtask.predict(batch))
        got = port.predict(batch)
        np.testing.assert_array_equal(got["duration"], np.asarray(want["duration"]))
        np.testing.assert_array_equal(got["mel_length"], np.asarray(want["mel_length"]))
        _hold_wavs(got["wav"], want["wav"], got["mel_length"], FLIP_REL)
        _, _, feats = port.predict_features(batch)
        np.testing.assert_allclose(feats.numpy(), _jax_features(jtask, batch), atol=FEAT_TOL, rtol=0)
        same = port._decode(feats).numpy()
        assert _rel(same, _jax_int8_decode(jtask, feats)) < WAV_REL
        for a, b in zip(got["wav"], same):
            np.testing.assert_array_equal(a, b[: a.shape[0]])
    for site, s in jtask._jit_cache["int8"].scales.items():
        assert port._int8_state.scales[site] == pytest.approx(s, rel=STATE_RTOL), site
    assert any(k[0] == "syn8" for k in port.shapes) and not any(k[0] == "syn" for k in port.shapes)


def test_predict_stream_int8_matches_jax_and_the_int8_predict(tts_tasks):
    jtask, port = tts_tasks
    batch = _tts_batch(True, seed=7)
    _jax(lambda: jtask.predict(_tts_batch(True)))  # calibrated on the same first batch as the port
    port.predict(_tts_batch(True))
    jmeta, jchunks = _jax(lambda: jtask.predict_stream(batch, chunk_frames=8))
    jwav = np.concatenate([np.asarray(c) for c in jchunks], axis=1)
    meta, chunks = port.predict_stream(batch, chunk_frames=8)
    pieces = list(chunks)
    assert len(pieces) > 1
    wav = np.concatenate(pieces, axis=1)
    np.testing.assert_array_equal(meta["wav_length"], np.asarray(jmeta["wav_length"]))
    assert wav.shape == jwav.shape
    for i, n in enumerate(meta["wav_length"]):
        assert _rel(wav[i, :n], jwav[i, :n]) < FLIP_REL
    whole = port.predict(batch)
    for i, n in enumerate(meta["wav_length"]):
        np.testing.assert_allclose(wav[i, :n], whole["wav"][i], atol=1e-6, rtol=0)
    assert any(k[0] == "stream8" for k in port.shapes)


def test_reload_drops_the_int8_state(tiny_pair):
    port = _port_task(tiny_pair["am"])
    port.int8_decoder = True
    batch = _tts_batch(True)
    before = port.predict(batch)
    state = port._int8_state
    assert state is not None and state.scales
    ck = t_load_checkpoint(tiny_pair["am"])
    engine = BatchingEngine(port, sample_rate=1600, batch_size=3, text_length=16)
    engine.reload(ck["state"])
    assert port._int8_state is None
    after = port.predict(batch)
    assert port._int8_state is not None and port._int8_state is not state
    for a, b in zip(after["wav"], before["wav"]):
        np.testing.assert_array_equal(a, b)  # the same weights and batch calibrate the same


# --------------------------------------------------------- entry points


def test_serve_int8_warms_the_int8_shapes(tiny_pair, capsys):
    rc = t_serve.main(["-m", tiny_pair["am"], "--device", "cpu", "--warmup-only", "--int8", "--batch-size", "2",
                       "--max-frames", "64", "--warmup-lengths", "8", "--stream-chunk-frames", "8"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["streaming_warmed"] and line["device"] == "cpu"
    assert line["shapes"] == 3  # ("dur", 256), ("syn8", 256, 64), ("stream8", 8, 256, 64)


def test_engine_over_int8_serves_without_cold_shapes(tiny_pair):
    port = _port_task(tiny_pair["am"])
    port.int8_decoder = True
    engine = BatchingEngine(port, sample_rate=1600, batch_size=2, text_length=16, max_frames=64,
                            stream_chunk_frames=8)
    engine.start(warmup={"text_lengths": [8]})
    try:
        assert port._int8_state is not None and port._int8_state.scales  # warmup's first batch calibrated
        wav = engine.synthesize("3_1 5_2 7_0 2_1", timeout=120)
        pieces = list(engine.synthesize_stream("4_2 6_1", timeout=120))
        assert wav.ndim == 1 and wav.size > 0 and np.all(np.isfinite(wav)) and pieces
        stats = engine.snapshot()
        assert stats["cold_shapes"] == 0 and stats["kernel_builds"] == 0
    finally:
        engine.stop()


def _texts_by_total(task, Lt=32, B=4, seed=0):
    """Seeded two-stream phone strings keyed by the frame total the task
    predicts for them in the engine's shapes (text bucket ``Lt``, the row
    repeated to batch ``B``): the first string drawn for each total."""
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


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_engine_decodes_a_request_alike_alone_and_in_a_shared_batch(tiny_pair, int8):
    """Requests of different lengths ride one batch and one text bucket;
    each decodes as it does alone. Among them one whose frame total fills
    its bucket exactly (64 frames), and a longer one whose bucket, with the
    engine's frame margin, is larger than the first's alone. With the JAX
    package's bucket choice (no margin) the first has no padding alone and
    is padded in the batch, and padded frames reach the decoder's and the
    residual chain's outputs: it came out 0.42 apart at its end here, and
    on the card a 32-phone request came out 1.03 apart in relative L2,
    fp32 and int8 alike."""
    port = _port_task(tiny_pair["am"])
    by_total = _texts_by_total(port, Lt=48)
    texts = [by_total[64], by_total[63], by_total[max(by_total)], by_total[min(t for t in by_total if t >= 30)]]
    port.int8_decoder = int8
    kw = dict(sample_rate=1600, batch_size=4, text_length=48, max_frames=256, stream_chunk_frames=8)
    eng = BatchingEngine(port, window_ms=0.0, **kw).start(warmup={"text_lengths": [48]})
    try:
        alone = [eng.synthesize(t, timeout=120) for t in texts]
    finally:
        eng.stop()
    margin = port.frame_margin
    assert margin == port.padding_reach_frames() > 0
    # the shared batch's frame bucket is larger than the 64-frame request's alone
    assert bucket_length(max(by_total) + margin, FRAME_BUCKETS) > bucket_length(64 + margin, FRAME_BUCKETS)
    eng = BatchingEngine(port, window_ms=500.0, **kw).start()
    try:
        results = [None] * len(texts)

        def run(i):
            results[i] = eng.synthesize(texts[i], timeout=120)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(texts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert eng.snapshot()["batches"] == 1 and all(r is not None for r in results)
    finally:
        eng.stop()
    assert [w.shape[0] for w in alone[:3]] == [64 * FRAMESHIFT, 63 * FRAMESHIFT, max(by_total) * FRAMESHIFT]
    for got, want in zip(results, alone):
        assert got.shape == want.shape and np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got, want, atol=SOLO_TOL, rtol=0)


def test_infer_int8_on_cpu_matches_jax(tiny_pair, tmp_path):
    """``infer --int8``: each utterance's wav (saved as .npy) against the JAX
    package's int8 task on the same test list, calibrated on the same first
    batch."""
    lines = {"u0": {"text": "3_1 5_2 7_0 2_1 9_3"}, "u1": {"text": "4_2 6_1"}, "u2": {"text": "1_1 2_2 3_3 4_4"}}
    test_list = str(tmp_path / "test.yaml")
    cfg = dict(t_load_checkpoint(tiny_pair["am"])["config"])
    cfg["save_features"] = [["wav", ".npy"]]
    cfg_path = str(tmp_path / "am.yaml")
    for path, tree in ((test_list, lines), (cfg_path, cfg)):
        with open(path, "w") as f:
            yaml.safe_dump(tree, f)
    out_dir = str(tmp_path / "out")
    t_infer.main(["-m", tiny_pair["am"], "-c", cfg_path, "-t", test_list, "-o", out_dir, "--int8", "--device", "cpu"])

    jtask = _jax_task(tiny_pair["am"])
    jtask.int8_decoder = True
    config = Config(cfg_path)
    config["dataset"] = config.get("testset", config.dataset)
    dataset = j_build_dataset(config, training=False, id_list=test_list)
    seen = 0
    for batch in j_finite_loader(dataset, 1):
        name = dataset.id_list[int(batch.pop("_id")[0])][0]
        want = np.asarray(_jax(lambda: jtask.infer_step(batch))["wav"][0])
        got = np.load(os.path.join(out_dir, f"{name}_wav.npy"))
        assert got.shape == want.shape and got.shape[0] % FRAMESHIFT == 0
        assert _rel(got, want) < WAV_REL
        seen += 1
    assert seen == len(lines)
