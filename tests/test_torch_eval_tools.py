"""The quality tools around training in the port against msmctts_tpu, on the
CPU: ``utils/audio.py``, the AS-MCD sweep (``tools/as_mcd_sweep.py``),
``MSMCTTS.debug_step`` and ``infer --debug``, ``utils/logger.py``, the
trainers' ``evaluate()`` and its hook in the training loop, and checkpoint
stitching.

Tolerances.
  * audio DSP on equal inputs: 1e-6 relative (observed: equal, or a few
    ulps where scipy and numpy sum in one order and the port's filterbank
    is built by the same formulas).
  * the sweep's JSON line (dB, 3 decimals) on two tiny snapshots: 1e-3 dB,
    fp32 and ``--int8``.
  * ``debug_step``: codeword indices equal, quantized embeddings 1e-5, wav
    1e-5 (the tiny AE in fp32).
  * ``evaluate()``: wav 5e-4 (the card-vs-CPU bound of analysis-synthesis),
    the [0, 1] mel image 1e-5; ``LossMeter`` means: 1e-12 relative (the same
    float64 sums).
  * stitching: equal trees; the stitched state's parts bit-equal to their
    checkpoints'.
"""

import contextlib
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

import msmctts_tpu.utils.audio as JA
from msmctts_tpu.config import Config
from msmctts_tpu.config import component_kwargs
from msmctts_tpu.data.loader import DataLoader as JDataLoader
from msmctts_tpu.data.loader import finite_loader as j_finite_loader
from msmctts_tpu.parallel.mesh import make_mesh
from msmctts_tpu.registry import get_trainer
from msmctts_tpu.tasks import build_task
from msmctts_tpu.training.base_trainer import build_dataset_from_config as j_build_dataset
from msmctts_tpu.utils import logger as JL
from msmctts_tpu.utils.checkpoint import filter_state_by_regex as j_filter
from msmctts_tpu.utils.checkpoint import load_checkpoint, merge_states as j_merge, save_checkpoint
import msmctts_tpu_torch.utils.audio as TA
from msmctts_tpu_torch import infer as t_infer
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.config import component_kwargs as t_component_kwargs
from msmctts_tpu_torch.data.loader import to_device
from msmctts_tpu_torch.registry import get_trainer as t_get_trainer
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.tools import as_mcd_sweep as t_sweep
from msmctts_tpu_torch.training import base_trainer as t_base
from msmctts_tpu_torch.utils import logger as TL
from msmctts_tpu_torch.utils.checkpoint import filter_state_by_regex as t_filter
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint as t_load_checkpoint
from msmctts_tpu_torch.utils.checkpoint import merge_states as t_merge
from tests import torch_parallel_workers as workers
from tests.test_torch_emb_train import EMB_KEYS, _emb_config
from tests.test_torch_qat import tiny_ae  # noqa: F401  (module fixture)
from tests.test_torch_slice import _gains
from tests.tiny import FRAMESHIFT, tiny_ae_config, write_tiny_dataset, write_tiny_emb_dataset

torch.set_num_threads(2)

DSP_RTOL = 1e-6
MCD_ATOL = 1e-3
DEBUG_TOL = 1e-5
EVAL_WAV_TOL = 5e-4
EVAL_IMG_TOL = 1e-5


def _jax(fn):
    with jax.default_matmul_precision("highest"):
        return fn()


class Recorder:
    """A tensorboard writer that keeps what it is given."""

    def __init__(self):
        self.calls = []

    def add_scalar(self, name, value, step):
        self.calls.append(("scalar", name, float(value), step))

    def add_image(self, name, img, step, dataformats="HWC"):
        self.calls.append(("image", name, np.asarray(img), step))

    def add_audio(self, name, wav, step, sample_rate=None):
        self.calls.append(("audio", name, np.asarray(wav), step, sample_rate))

    def close(self):
        pass

    def of(self, kind):
        return [c for c in self.calls if c[0] == kind]


# ------------------------------------------------------------------ audio


def _wav(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 24000
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.normal(size=n)).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=DSP_RTOL, atol=DSP_RTOL * max(float(np.abs(want).max()), 1e-30))


CFG24 = dict(sample_rate=24000)
CFG16 = dict(sample_rate=16000, num_mels=64, symmetric_specs=False)


@pytest.mark.parametrize("cfg", [CFG24, CFG16], ids=["24k-symmetric", "16k-one-sided"])
@pytest.mark.parametrize("fn", ["melspectrogram", "spectrogram"])
def test_features_equal_jax(fn, cfg):
    wav = _wav()
    _close(getattr(TA, fn)(wav, TA.AudioConfig(**cfg)), getattr(JA, fn)(wav, JA.AudioConfig(**cfg)))


def test_config_derived_sizes_equal_jax():
    for cfg in (CFG24, CFG16, dict(sample_rate=1600)):
        t, j = TA.AudioConfig(**cfg), JA.AudioConfig(**cfg)
        assert (t.n_fft, t.hop_length, t.win_length) == (j.n_fft, j.hop_length, j.win_length)


def test_stft_and_normalization_equal_jax():
    wav = _wav(3000, 1).astype(np.float64)
    _close(TA.stft_np(wav, 512, 120, 300), JA.stft_np(wav, 512, 120, 300))
    S = np.linspace(-120, 10, 50)
    for cfg in (CFG24, CFG16):
        t, j = TA.AudioConfig(**cfg), JA.AudioConfig(**cfg)
        _close(TA._normalize(S, t), JA._normalize(S, j))
        _close(TA.denormalize(TA._normalize(S, t), t), JA.denormalize(JA._normalize(S, j), j))


def test_griffin_lim_equals_jax():
    cfg = dict(sample_rate=8000, num_freq=257)
    wav = _wav(2400, 2)
    spec = JA.spectrogram(wav, JA.AudioConfig(**cfg))
    _close(TA.griffin_lim(spec, TA.AudioConfig(**cfg), n_iters=4), JA.griffin_lim(spec, JA.AudioConfig(**cfg), n_iters=4))


def test_preemphasis_and_mulaw_equal_jax():
    wav = _wav(2000, 3).astype(np.float64)
    _close(TA.preemphasis(wav, 0.97), JA.preemphasis(wav, 0.97))
    _close(TA.inv_preemphasis(TA.preemphasis(wav, 0.97), 0.97), JA.inv_preemphasis(JA.preemphasis(wav, 0.97), 0.97))
    np.testing.assert_allclose(TA.inv_preemphasis(TA.preemphasis(wav, 0.97), 0.97), wav, atol=1e-9)
    x = np.linspace(-1.2, 1.2, 1001)
    codes = TA.mulaw_encode(x)
    np.testing.assert_array_equal(codes, JA.mulaw_encode(x))
    assert codes.min() == 0 and codes.max() == 255
    _close(TA.mulaw_decode(codes), JA.mulaw_decode(codes))


@pytest.mark.parametrize("kind", ["lowpass", "highpass"])
def test_biquads_equal_jax(kind):
    for cutoff, sr, q in ((1000.0, 24000, 0.707), (60.0, 16000, 1.2)):
        bt, at = getattr(TA, f"biquad_{kind}")(cutoff, sr, q)
        bj, aj = getattr(JA, f"biquad_{kind}")(cutoff, sr, q)
        _close(bt, bj)
        _close(at, aj)


def test_sine_excitation_and_mcd_equal_jax():
    lf0 = np.log(np.linspace(80, 300, 40)) * (np.arange(40) % 7 != 0)
    _close(TA.lf0_to_sine(lf0, 120, 24000, seed=3), JA.lf0_to_sine(lf0, 120, 24000, seed=3))
    a = JA.melspectrogram(_wav(6000, 4), JA.AudioConfig())
    b = JA.melspectrogram(_wav(5400, 5), JA.AudioConfig())
    assert TA.mcd(a, b) == pytest.approx(JA.mcd(a, b), rel=1e-12) and TA.mcd(a, a) == 0.0


# ----------------------------------------------------------------- logger


@pytest.mark.parametrize("interval", [1, 3])
def test_loss_meter_means_equal_jax(interval):
    rng = np.random.default_rng(interval)
    jw, tw = Recorder(), Recorder()
    jm, tm = JL.LossMeter(jw, interval), TL.LossMeter(tw, interval)
    for it in range(1, 10):
        scalars = {"g_loss": float(rng.normal()), "d_loss": float(rng.normal())}
        if it % 2:
            scalars["mel_loss"] = float(rng.uniform())
        jm.update(it, scalars)
        tm.update(it, scalars)
    assert [c[1:2] + c[3:] for c in tw.calls] == [c[1:2] + c[3:] for c in jw.calls] and tw.calls
    for a, b in zip(tw.calls, jw.calls):
        assert a[2] == pytest.approx(b[2], rel=1e-12)
    silent, j_silent = TL.LossMeter(None, 1), JL.LossMeter(None, 1)
    for m in (silent, j_silent):
        m.update(1, {"x": 1.0})
        m.update(2, {"x": 3.0})
    assert dict(silent.sums) == dict(j_silent.sums) == {"x": 4.0}  # without a writer nothing is flushed


def test_logger_text_config_and_audio_fallback(tmp_path, capsys):
    logs = {}
    for name, mod in (("jax", JL), ("port", TL)):
        lg = mod.Logger(str(tmp_path / name), rank=1)  # not rank 0: no writer
        assert lg.writer is None
        lg.log_config({"a": 1, "b": [1, 2]})
        lg.text("step 3 g_loss=1.0000")
        lg.log(3, {"loss": {"g_loss": 1.0}, "image": {"eval/pred_mel": np.ones((4, 5, 1))},
                   "audio": {"eval/wav": (np.linspace(-0.5, 0.5, 100), 1600)}})
        lg.close()
        logs[name] = [line.split("] ", 1)[1] for line in open(lg.log_path)]
        wav_path = tmp_path / name / "eval_audio" / "eval_wav_3.wav"
        assert wav_path.exists()
        logs[name + "_wav"] = wav_path.read_bytes()
        assert os.path.basename(lg.log_path).startswith("train_rank1_")
    assert logs["port"] == logs["jax"] and logs["port_wav"] == logs["jax_wav"]
    assert "step 3 g_loss=1.0000" in capsys.readouterr().out  # the port echoes its lines


# ------------------------------------------------------------ stitching


def _tree(seed):
    rng = np.random.default_rng(seed)
    leaf = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"params": {"autoencoder": {"encoder": {"w": leaf(3, 2), "b": leaf(2)}, "decoder": {"w": leaf(4)},
                                       "quantizer": {"embed": leaf(2, 2)}},
                       "discriminator": {"w": leaf(5)}},
            "codebook": {"quantizer": {"embed": leaf(2, 3)}}, "model_state": {}, "opt_state": {"count": 3}}


@pytest.mark.parametrize("pattern", ["autoencoder/encoder", "^codebook", "decoder|discriminator", "nothing", "params"])
def test_stitching_helpers_equal_jax(pattern):
    base, part = _tree(0), _tree(1)
    part["params"]["autoencoder"]["extra"] = {"w": np.ones(2, np.float32)}  # only in the part: dropped
    want = j_merge(base, j_filter(part, pattern))
    got = t_merge(base, t_filter(part, pattern))
    jf = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    tf = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert jf.keys() == tf.keys()
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=str(k))
    assert t_filter(part, pattern) == {} if pattern == "nothing" else True


def _port_trainer(config_dict):
    cfg = TConfig(config_dict)
    task = t_build_task(cfg, device="cpu", mode="train")
    return t_get_trainer(cfg.trainer["_name"])(cfg, task, **t_component_kwargs(cfg.trainer))


def test_trainer_stitches_a_state_from_two_checkpoints(tmp_path):
    """``restore_checkpoint_path: [[regex, path], ...]``: the encoder of one
    checkpoint, the decoder of another, everything else from the fresh init;
    no optimizer state, iteration 0."""
    corpus = str(tmp_path)
    write_tiny_dataset(corpus)
    states = []
    for seed in (11, 12):
        tr = _port_trainer(tiny_ae_config(corpus).to_dict())
        tr.seed = seed
        tr.init_state()
        states.append(tr.state_tree())
    paths = [str(tmp_path / f"part{i}") for i in range(2)]
    for p, s in zip(paths, states):
        save_checkpoint(p, s, 7, {})
    cfg = tiny_ae_config(corpus).to_dict()
    cfg["save_checkpoint_dir"] = str(tmp_path / "ckpt")
    cfg["restore_checkpoint_path"] = [["autoencoder/encoder", paths[0]], ["autoencoder/decoder", paths[1]]]
    tr = _port_trainer(cfg)
    tr.attempt_resume()
    got = tr.state_tree()
    fresh = _port_trainer(tiny_ae_config(corpus).to_dict())
    fresh.init_state()
    init = fresh.state_tree()
    want = j_merge(j_merge(init, j_filter(states[0], "autoencoder/encoder")), j_filter(states[1], "autoencoder/decoder"))
    gf, wf = dict(jax.tree_util.tree_flatten_with_path(got)[0]), dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert gf.keys() == wf.keys()
    n_enc = n_dec = 0
    for k, v in wf.items():
        np.testing.assert_array_equal(gf[k], v, err_msg=str(k))
        path = "/".join(str(p.key) for p in k)
        n_enc += "autoencoder/encoder" in path
        n_dec += "autoencoder/decoder" in path
    assert n_enc > 0 and n_dec > 0 and tr.iteration == 0
    enc = dict(jax.tree_util.tree_flatten_with_path(states[0]["params"]["autoencoder"]["encoder"])[0])
    genc = dict(jax.tree_util.tree_flatten_with_path(got["params"]["autoencoder"]["encoder"])[0])
    assert all(np.array_equal(genc[k], v) for k, v in enc.items())


# -------------------------------------------------------------- debug_step


def _tasks(path, int8=False):
    ck = load_checkpoint(path)
    jt = build_task(Config(ck["config"]), mode="infer")
    jt.load_variables(ck["state"])
    tck = t_load_checkpoint(path)
    tt = t_build_task(TConfig(tck["config"]), device="cpu")
    tt.load_variables(tck["state"])
    jt.int8_decoder = tt.int8_decoder = int8
    return jt, tt, Config(ck["config"])


def test_debug_step_matches_jax(tiny_ae):
    jt, tt, config = _tasks(tiny_ae["ckpt"])
    dataset = j_build_dataset(config, training=False, id_list=os.path.join(tiny_ae["dir"], "train.list"))
    batch = next(j_finite_loader(dataset, 3))
    batch.pop("_id")
    want = _jax(lambda: jt.debug_step(batch))
    got = tt.debug_step(batch)
    assert sorted(got) == sorted(want) and "indices" in got and "embedding" in got
    assert len(got["indices"]) == len(want["indices"]) == 2
    for a, b in zip(got["indices"], want["indices"]):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(got["embedding"], want["embedding"]):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=DEBUG_TOL)
    for a, b in zip(got["wav"], want["wav"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=DEBUG_TOL)
    plain = tt.infer_step(batch)
    for a, b in zip(got["wav"], plain["wav"]):
        np.testing.assert_array_equal(a, b)


def test_infer_debug_saves_what_jax_saves(tiny_ae, tmp_path, monkeypatch):
    """``infer --debug`` with ``save_features`` naming the debug outputs:
    the files of the port's CLI against those of the JAX package's."""
    import infer as j_infer

    cfg = dict(load_checkpoint(tiny_ae["ckpt"])["config"])
    cfg["save_features"] = [["wav", ".npy"], ["indices", ".npy"], ["embedding", ".npy"]]
    cfg_path = str(tmp_path / "ae.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    test_list = os.path.join(tiny_ae["dir"], "train.list")
    t_out, j_out = str(tmp_path / "port"), str(tmp_path / "jax")
    t_infer.main(["-m", tiny_ae["ckpt"], "-c", cfg_path, "-t", test_list, "-o", t_out, "-b", "2", "--debug",
                  "--device", "cpu"])
    monkeypatch.setenv("MSMCTTS_COMPILE_CACHE", "0")
    monkeypatch.setattr(sys, "argv", ["infer.py", "-m", tiny_ae["ckpt"], "-c", cfg_path, "-t", test_list, "-o", j_out,
                                      "-b", "2", "--debug"])
    _jax(j_infer.main)
    names = sorted(os.listdir(j_out))
    assert names == sorted(os.listdir(t_out)) and any("_indices" in n for n in names)
    for name in names:
        a, b = np.load(os.path.join(t_out, name)), np.load(os.path.join(j_out, name))
        assert a.shape == b.shape, name
        if "_indices" in name:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=DEBUG_TOL, err_msg=name)


def test_debug_step_refuses_an_emb_autoencoder():
    from msmctts_tpu_torch.tasks import MSMCTTS

    task = MSMCTTS.__new__(MSMCTTS)
    task.training_mode = "train_autoencoder"
    task.networks = {"autoencoder": torch.nn.Linear(1, 1)}
    with pytest.raises(NotImplementedError, match="mel analysis"):
        task.debug_step({})


# ------------------------------------------------------------------ sweep


@pytest.fixture(scope="module")
def sweep_dir(tiny_ae, tmp_path_factory):
    """Two snapshots of the tiny AE (the second with other decoder gains)."""
    d = str(tmp_path_factory.mktemp("sweep"))
    ck = load_checkpoint(tiny_ae["ckpt"])
    save_checkpoint(os.path.join(d, "model_1"), ck["state"], 1, ck["config"])
    state = ck["state"]
    state["params"]["autoencoder"]["decoder"] = _gains(state["params"]["autoencoder"]["decoder"],
                                                       np.random.default_rng(5))
    save_checkpoint(os.path.join(d, "model_2"), state, 2, ck["config"])
    save_checkpoint(os.path.join(d, "model_2_qat"), state, 2, ck["config"])  # not a snapshot name
    return d


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_as_mcd_sweep_matches_jax(tiny_ae, sweep_dir, int8, monkeypatch):
    import tools.as_mcd_sweep as j_sweep

    args = ["--ckpt-dir", sweep_dir, "-t", os.path.join(tiny_ae["dir"], "train.list"),
            "--ref-wav", os.path.join(tiny_ae["dir"], "wav", "{}.wav"), "-b", "2", *(["--int8"] if int8 else [])]
    monkeypatch.setenv("MSMCTTS_COMPILE_CACHE", "0")
    monkeypatch.setattr(sys, "argv", ["as_mcd_sweep.py", *args, "--platform", "cpu"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _jax(j_sweep.main)
    want = json.loads(buf.getvalue().splitlines()[-1])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = t_sweep.main([*args, "--device", "cpu"])
    line = json.loads(buf.getvalue().splitlines()[-1])
    assert line == got
    assert {k: v for k, v in line.items() if k != "snapshots"} == {k: v for k, v in want.items() if k != "snapshots"}
    assert sorted(line["snapshots"]) == sorted(want["snapshots"]) == ["1", "2"]
    for it, v in want["snapshots"].items():
        assert abs(line["snapshots"][it] - v) <= MCD_ATOL + 1e-9, (line, want)
    assert line["snapshots"]["1"] != line["snapshots"]["2"]


def test_as_mcd_sweep_refuses_missing_snapshots(tiny_ae, sweep_dir):
    with pytest.raises(SystemExit, match="not found"):
        t_sweep.main(["--ckpt-dir", sweep_dir, "-t", "x", "--ref-wav", "{}", "--snapshots", "9", "--device", "cpu"])
    assert sorted(t_sweep.find_snapshots(sweep_dir)) == [1, 2]


# --------------------------------------------------------------- evaluate


@pytest.fixture(scope="module")
def vqgan_pair(tmp_path_factory):
    """The tiny AE recipe's JAX trainer after init and the port's trainer
    holding the same state; one training batch."""
    corpus = str(tmp_path_factory.mktemp("eval_corpus"))
    write_tiny_dataset(corpus)
    config = tiny_ae_config(corpus)
    config["save_checkpoint_dir"] = corpus + "/ckpt"
    with jax.default_matmul_precision("highest"):
        jtask = build_task(config, mode="train")
        jtr = get_trainer("VQGANTrainer")(config, jtask, mesh=make_mesh(1), **component_kwargs(config.trainer))
        batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0)))
        batch = {k: batch[k] for k in ("mel", "mel_length", "wav")}
        jtr.state = jtr.init_state(jax.random.PRNGKey(0), batch)
    # audible decoder gains in both
    jtr.state = jax.device_get(jtr.state)
    jtr.state["params"]["autoencoder"]["decoder"] = _gains(jtr.state["params"]["autoencoder"]["decoder"],
                                                           np.random.default_rng(2))
    tr = _port_trainer(config.to_dict())
    W.train_state_from_jax(jtr.state, tr.ae, tr.disc)
    return dict(jtr=jtr, tr=tr, batch=batch, config=config)


def _payloads(jtr, tr, batch, jbatch=None, tmp=None):
    jl = JL.Logger(tmp + "/j", use_tensorboard=False)
    tl = TL.Logger(tmp + "/t", use_tensorboard=False)
    jl.writer, tl.writer = Recorder(), Recorder()
    _jax(lambda: jtr.evaluate(jbatch if jbatch is not None else batch, jl, 5))
    tr.evaluate(to_device(batch, "cpu"), tl, 5)
    return jl.writer, tl.writer


def _hold_payloads(jw, tw):
    assert [c[:2] for c in tw.calls] == [c[:2] for c in jw.calls] == [("image", "eval/pred_mel"), ("audio", "eval/wav")]
    (_, _, ti, ts), (_, _, ji, js) = tw.of("image")[0], jw.of("image")[0]
    assert ts == js == 5 and ti.shape == ji.shape and ti.min() >= 0 and ti.max() <= 1
    np.testing.assert_allclose(ti, ji, rtol=0, atol=EVAL_IMG_TOL)
    (_, _, ta, _, tsr), (_, _, ja, _, jsr) = tw.of("audio")[0], jw.of("audio")[0]
    assert tsr == jsr and ta.shape == ja.shape and np.abs(ja).max() > 1e-3
    np.testing.assert_allclose(ta, ja, rtol=0, atol=EVAL_WAV_TOL)


def test_vqgan_evaluate_payload_matches_jax(vqgan_pair, tmp_path):
    tr = vqgan_pair["tr"]
    tr.ae.train()
    jw, tw = _payloads(vqgan_pair["jtr"], tr, vqgan_pair["batch"], tmp=str(tmp_path))
    _hold_payloads(jw, tw)
    n = int(vqgan_pair["batch"]["mel_length"][0])
    assert tw.of("audio")[0][2].shape == (1, n * FRAMESHIFT)
    assert tr.ae.training  # back to training mode
    # the same wav as the analysis-synthesis of that row
    task = t_build_task(TConfig(vqgan_pair["config"].to_dict()), device="cpu")
    W.load_numpy_state(task.networks["autoencoder"], W.msmc_vqgan_from_jax(
        {"params": vqgan_pair["jtr"].state["params"]["autoencoder"], "codebook": vqgan_pair["jtr"].state["codebook"],
         "batch_stats": None}))
    # the row as the batch pads it: padded frames reach the audio
    ref = task.analysis_synthesis({k: np.asarray(vqgan_pair["batch"][k])[:1] for k in ("mel", "mel_length")})["wav"][0]
    np.testing.assert_allclose(tw.of("audio")[0][2][0], ref, rtol=0, atol=EVAL_WAV_TOL)


def test_evaluate_without_a_writer_does_nothing(vqgan_pair, tmp_path):
    tr = vqgan_pair["tr"]
    lg = TL.Logger(str(tmp_path), use_tensorboard=False)
    calls = []
    tr.ae.forward = lambda *a, **k: calls.append(1)  # would be called by an evaluation
    try:
        assert tr.evaluate(to_device(vqgan_pair["batch"], "cpu"), lg, 1) is None
    finally:
        del tr.ae.forward
    assert not calls and not os.path.exists(os.path.join(str(tmp_path), "eval_audio"))


def test_training_loop_evaluates_every_interval_and_survives_a_failure(tmp_path, monkeypatch):
    corpus = str(tmp_path)
    write_tiny_dataset(corpus)
    cfg = tiny_ae_config(corpus).to_dict()
    cfg["trainer"]["eval_inteval_iters"] = 2
    cfg["save_checkpoint_dir"] = str(tmp_path / "ckpt")
    writers = []

    class RecordingLogger(TL.Logger):
        def __init__(self, *a, **k):
            super().__init__(*a, use_tensorboard=False, **{x: y for x, y in k.items() if x != "use_tensorboard"})
            self.writer = self.meter.writer = Recorder()
            self.meter.interval = 1
            writers.append(self.writer)

    monkeypatch.setattr(t_base, "Logger", RecordingLogger)
    tr = _port_trainer(cfg)
    assert tr.eval_interval == 2
    tr.train(max_steps=4, log_every=1)
    w = writers[0]
    assert [c[3] for c in w.of("audio")] == [2, 4] and [c[3] for c in w.of("image")] == [2, 4]
    assert {c[1] for c in w.of("scalar")} >= {"g_loss", "d_loss", "steps_per_sec"}
    assert sorted({c[3] for c in w.of("scalar")}) == [1, 2, 3, 4]
    # a failing evaluation is logged and the loop goes on
    cfg["save_checkpoint_dir"] = str(tmp_path / "ckpt2")
    tr = _port_trainer(cfg)

    def broken(batch, logger, iteration):
        raise RuntimeError("no audio today")

    tr.evaluate = broken
    tr.train(max_steps=3, log_every=1)
    assert tr.iteration == 3
    log = open([os.path.join(cfg["save_checkpoint_dir"], f) for f in os.listdir(cfg["save_checkpoint_dir"])
                if f.endswith(".log")][0]).read()
    assert "evaluate() failed at 2: no audio today" in log and "step 3 " in log and "config: " in log


@pytest.fixture(scope="module")
def emb_pair(tmp_path_factory):
    corpus = str(tmp_path_factory.mktemp("eval_emb_corpus"))
    write_tiny_emb_dataset(corpus)
    config = _emb_config(corpus, corpus + "/ckpt")
    with jax.default_matmul_precision("highest"):
        jtask = build_task(config, mode="train")
        jtr = get_trainer("EmbVQGANTrainer")(config, jtask, mesh=make_mesh(1), **component_kwargs(config.trainer))
        batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0)))
        batch = {k: batch[k] for k in EMB_KEYS}
        jtr.state = jax.device_get(jtr.init_state(jax.random.PRNGKey(0), batch))
    jtr.state["params"]["autoencoder"]["decoder"] = _gains(jtr.state["params"]["autoencoder"]["decoder"],
                                                           np.random.default_rng(3))
    tr = workers.build_trainer(config.to_dict(), {})
    tr.load_state_tree(jtr.state)
    return dict(jtr=jtr, tr=tr, batch=batch)


def test_emb_evaluate_payload_matches_jax(emb_pair, tmp_path):
    jw, tw = _payloads(emb_pair["jtr"], emb_pair["tr"], emb_pair["batch"], tmp=str(tmp_path))
    _hold_payloads(jw, tw)
    assert emb_pair["tr"].ae.training
