"""The LJSpeech recipes' geometry (``examples/ljspeech/configs/``) in the port
against msmctts_tpu, on the CPU, at tiny widths: single-stream text
(``n_symbols [256]``, ``n_pred_scale [4, 1]``), a 256-sample hop at 22.05
kHz through the [8, 8, 2, 2] HiFi-GAN (kernels [16, 16, 4, 4], MRF kernels
3 / 7 / 11 at dilations 1 / 3 / 5), the coarse stage at 4x, and the UnivNet
discriminator at hop lengths 16 ... 256; then both shipped recipes at full
width through ``build_task(mode="train")``.

Tolerances (fp32, JAX under matmul precision "highest").
  * generator: 1e-5 of the output's peak, as ``test_torch_istft.py`` holds
    the other decoder families.
  * ``predict``: durations, frame counts, indices and embeddings equal; wav
    1e-4 (``test_torch_slice.py::test_predict_matches_jax``); the ``infer``
    CLI over a test list of inline single-stream phone strings against
    ``infer.py``: 1e-4 on the 16-bit samples both write.
  * the padding reach: a JAX decode of an utterance followed by the port's
    ``padding_reach_frames`` of padding against the same utterance in a
    bucket 64 frames longer, 1e-5 (the same model on another padded length).
  * one warmup and one GAN step: metrics 2e-5 relative, first-step
    gradients 1e-4 of each tensor's largest entry, codebook 2e-5 and
    parameters within 2 lr per step with at most 0.2 % beyond 1e-5
    (``test_torch_train_slice.py``, whose reasons hold here).
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from msmctts_tpu.config import Config
from msmctts_tpu.config import component_kwargs
from msmctts_tpu.models.hifigan import HifiGANGenerator as JGenerator
from msmctts_tpu.models.hifigan import receptive_field_frames as j_receptive_field_frames
from msmctts_tpu.models.predictor import MultiStagePredictor
from msmctts_tpu.parallel.mesh import make_mesh
from msmctts_tpu.registry import get_network, get_trainer
from msmctts_tpu.tasks import build_task
from msmctts_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from msmctts_tpu.utils.checkpoint import save_checkpoint
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.data.loader import to_device
from msmctts_tpu_torch.models.hifigan import HifiGANGenerator as TGenerator
from msmctts_tpu_torch.models.hifigan import receptive_field_frames as t_receptive_field_frames
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint as t_load_checkpoint
from tests.test_torch_slice import _gains
from tests.test_torch_train_slice import _flat, _no_dropout, _port_trainer, _recording
from tests.tiny import MEL_DIM, tiny_ae_config, tiny_am_config

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LJ_DIR = os.path.join(ROOT, "examples", "ljspeech", "configs")
SR, HOP = 22050, 256
LJ_DECODER = {
    "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 32,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}
LJ_HOPS = [16, 32, 64, 128, 256]
LR = 2e-4
GEN_TOL = 1e-5
WAV_TOL = 1e-4
REACH_TOL = 1e-5
METRIC_RTOL = 2e-5
GRAD_RTOL = 1e-4
CODEBOOK_TOL = 2e-5


def _jax(fn):
    with jax.default_matmul_precision("highest"):
        return fn()


def _lj_ae_config(tmpdir):
    """The tiny recipe reshaped to the LJSpeech autoencoder's geometry."""
    config = tiny_ae_config(tmpdir)
    config["id"] = "tiny_ljspeech_ae"
    ae = config["task"]["autoencoder"]
    ae["encoder_config"]["downsample_scales"] = [1, 4]
    ae["quantizer_config"]["n_heads"] = 4
    ae["decoder_config"] = dict(LJ_DECODER)
    config["task"]["discriminator"] = {
        "_name": "UnivNetDiscriminator",
        "mrd_config": {"hop_lengths": LJ_HOPS, "hidden_channels": [32] * len(LJ_HOPS), "domain": "double",
                       "mel_scale": True, "sample_rate": SR},
        "mpd_config": {"periods": [2, 3, 5, 7, 11], "channels": 4, "max_channels": 16},
    }
    trainer = config["trainer"]
    trainer["sample_lengths"] = 8 * HOP
    trainer.pop("stft_loss_config")  # the recipe's: the trainer's defaults at 22.05 kHz
    config["dataset"]["samplerate"] = SR
    config["dataset"]["frameshift"] = [HOP, 1]
    config["save_features"] = [["wav", ".wav", SR]]
    return config


def _lj_am_config(tmpdir, ae_path):
    config = tiny_am_config(tmpdir, ae_path)
    config["id"] = "tiny_ljspeech_am"
    pred = config["task"]["predictor"]
    pred["n_symbols"] = [256]
    pred["n_pred_scale"] = [4, 1]
    config["dataset"]["samplerate"] = SR
    config["dataset"]["dimension"] = [1, 1, MEL_DIM]
    config["dataset"]["frameshift"] = [None, None, HOP]
    config["save_features"] = [["embedding", ".npy", None], ["wav", ".wav", SR]]
    return config


# ------------------------------------------------------------ the generator


@pytest.fixture(scope="module")
def lj_gen():
    x = np.random.default_rng(2).normal(size=(2, 12, 8)).astype(np.float32)
    cfg = dict(LJ_DECODER, num_mels=8)
    g = JGenerator(**cfg)
    v = jax.device_get(jax.jit(g.init)(jax.random.PRNGKey(0), x))  # an eager flax init takes tens of seconds
    v["params"] = _gains(v["params"], np.random.default_rng(0))
    port = TGenerator(**cfg)
    W.load_numpy_state(port, W.generator_from_jax(v["params"]))
    return dict(flax=g, v=v, port=port, x=x)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_ljspeech_generator_matches_flax(lj_gen, mode):
    g, v, port, x = lj_gen["flax"], lj_gen["v"], lj_gen["port"], lj_gen["x"]
    want = np.asarray(_jax(lambda: g.apply(v, x)))
    port.train(mode == "train")
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 12 * HOP, 1)
    peak = float(np.abs(want).max())
    assert peak > 1e-2
    np.testing.assert_allclose(got, want, atol=GEN_TOL * peak, rtol=0)


def test_ljspeech_receptive_field_matches_jax():
    recipe = yaml.safe_load(open(os.path.join(LJ_DIR, "msmc_vq_gan.yaml")))["task"]["autoencoder"]["decoder_config"]
    for cfg in (LJ_DECODER, recipe):
        assert t_receptive_field_frames(cfg) == j_receptive_field_frames(cfg)
    assert t_receptive_field_frames(recipe) == 16


# ------------------------------------------------------- the tiny TTS pair


@pytest.fixture(scope="module")
def lj_pair(tmp_path_factory):
    """A tiny LJSpeech-geometry AE + AM initialised in JAX (decoder gains in
    [0.5, 1.5], durations biased to ~3 frames a phone) and written as
    checkpoints."""
    d = str(tmp_path_factory.mktemp("lj_pair"))
    rng = np.random.default_rng(0)
    ae_cfg = _lj_ae_config(d)
    node = ae_cfg.task["autoencoder"]
    ae = get_network(node["_name"])(**{k: v for k, v in node.items() if not k.startswith("_")})
    key = jax.random.PRNGKey(0)
    av = jax.device_get(jax.jit(lambda k: ae.init(
        {"params": k, "dropout": k}, np.zeros((1, 8, MEL_DIM), np.float32), np.array([8], np.int32),
        deterministic=True))(key))
    ae_path = os.path.join(d, "ae.ckpt")
    save_checkpoint(ae_path, {"params": {"autoencoder": _gains(av["params"], rng)}, "codebook": av["codebook"]}, 1,
                    ae_cfg.to_dict())
    am_cfg = _lj_am_config(d, ae_path)
    pnode = am_cfg.task["predictor"]
    pred = MultiStagePredictor(**{k: v for k, v in pnode.items() if not k.startswith("_")})
    pv = jax.jit(lambda k: pred.init(k, np.ones((1, 8, 1), np.int32), np.array([8], np.int32),
                                     dur=np.ones((1, 8), np.float32), max_frames=16))(key)
    pparams = MultiStagePredictor.bias_durations(jax.device_get(pv)["params"], 3.0)
    am_path = os.path.join(d, "am.ckpt")
    save_checkpoint(am_path, {"params": {"predictor": pparams}}, 1, am_cfg.to_dict())
    return {"ae": ae_path, "am": am_path}


def _tasks(path):
    jck = j_load_checkpoint(path)
    jtask = build_task(Config(jck["config"]), mode="infer")
    jtask.load_variables(jck["state"])
    jtask.pre_infer()
    ck = t_load_checkpoint(path)
    task = t_build_task(TConfig(ck["config"]), device="cpu")
    task.load_variables(ck["state"])
    task.pre_infer()
    return jtask, task


def _text_batch(forced):
    rng = np.random.default_rng(1)
    B, Lt = 3, 16
    text_length = np.array([11, 6, 16])
    valid = np.arange(Lt)[None] < text_length[:, None]
    batch = {"text": (rng.integers(1, 256, (B, Lt, 1)) * valid[..., None]).astype(np.int32),
             "text_length": text_length.astype(np.int32)}
    if forced:
        batch["dur"] = (rng.integers(1, 6, (B, Lt)) * valid).astype(np.float32)
    return batch


@pytest.mark.parametrize("forced", [True, False], ids=["forced-durations", "predicted-durations"])
def test_single_stream_predictor_matches_jax(lj_pair, forced):
    """The predictor's teacher-forced and free-running outputs, one text
    stream, the coarse stage at 4x: every stage's features before the snap."""
    from msmctts_tpu_torch.tasks import extract_codebooks

    jtask, task = _tasks(lj_pair["am"])
    batch = _text_batch(forced)
    p1 = _jax(lambda: jtask._predict_phase1(batch))
    jout = _jax(lambda: jtask.networks["predictor"].apply(
        jtask.variables["predictor"], p1["text"], p1["text_length"], dur=p1["durations_dev"].astype(np.float32),
        max_frames=p1["max_frames"], codebooks=p1["codebooks"]))
    pred = task.networks["predictor"]
    assert list(pred.n_symbols) == [256]
    with torch.inference_mode():
        tp1 = task._predict_phase1(batch)
        tout = pred(tp1["text"], tp1["text_length"], dur=tp1["durations"], max_frames=tp1["max_frames"],
                    codebooks=extract_codebooks(task.networks["autoencoder"]))
    assert tp1["max_frames"] == p1["max_frames"]
    np.testing.assert_array_equal(np.asarray(tp1["durations"]), np.asarray(p1["durations_dev"]))
    assert len(tout["feat"]) == len(jout["feat"]) == 2
    for a, b in zip(tout["feat"], jout["feat"]):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
    assert np.asarray(jout["feat"][0]).shape[1] * 4 == np.asarray(jout["feat"][1]).shape[1]


def test_ljspeech_predict_matches_jax(lj_pair):
    jtask, task = _tasks(lj_pair["am"])
    batch = _text_batch(False)
    want = _jax(lambda: jtask.infer_step(batch))
    got = task.infer_step(batch)
    np.testing.assert_array_equal(got["duration"], np.asarray(want["duration"]))
    np.testing.assert_array_equal(got["mel_length"], np.asarray(want["mel_length"]))
    assert int(np.asarray(want["mel_length"]).min()) > 0
    for a, b in zip(got["embedding"], want["embedding"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b, n in zip(got["wav"], want["wav"], got["mel_length"]):
        assert a.shape == (int(n) * HOP,)
        np.testing.assert_allclose(a, np.asarray(b), atol=WAV_TOL, rtol=0)
    assert max(float(np.abs(w).max()) for w in got["wav"]) > 1e-2


def test_ljspeech_infer_test_list_matches_jax(lj_pair, tmp_path, monkeypatch):
    """A test list of inline single-stream phone strings through the port's
    ``infer`` and the JAX ``infer.py``: the same files, wavs within 1e-4
    (both write 16-bit PCM), through each package's ``TTSDataset``."""
    import sys

    from scipy.io import wavfile

    import infer as j_infer
    from msmctts_tpu_torch import infer as t_infer

    rng = np.random.default_rng(7)
    test_list = str(tmp_path / "test.yaml")
    with open(test_list, "w") as f:
        yaml.safe_dump({f"lj{i}": {"text": " ".join(str(v) for v in rng.integers(1, 256, n))}
                        for i, n in enumerate((5, 12, 17))}, f)
    t_out, j_out = str(tmp_path / "port"), str(tmp_path / "jax")
    t_infer.main(["-m", lj_pair["am"], "-t", test_list, "-o", t_out, "-b", "2", "--device", "cpu"])
    monkeypatch.setenv("MSMCTTS_COMPILE_CACHE", "0")
    monkeypatch.setattr(sys, "argv", ["infer.py", "-m", lj_pair["am"], "-t", test_list, "-o", j_out, "-b", "2"])
    _jax(j_infer.main)
    names = sorted(n for n in os.listdir(j_out) if n.endswith("_wav.wav"))
    assert len(names) == 3 and names == sorted(n for n in os.listdir(t_out) if n.endswith("_wav.wav"))
    for name in names:
        (sr_a, a), (sr_b, b) = wavfile.read(os.path.join(t_out, name)), wavfile.read(os.path.join(j_out, name))
        assert sr_a == sr_b == SR and a.shape == b.shape and a.shape[0] % HOP == 0 and a.shape[0] > 0
        np.testing.assert_allclose(a / 32767.0, b / 32767.0, atol=WAV_TOL, rtol=0, err_msg=name)


def test_padding_reach_frames_bounds_the_jax_decode(lj_pair):
    """The port's ``padding_reach_frames`` for the LJSpeech geometry (the
    decoder's receptive field against the coarse stage's prior at 4x) is
    what the JAX package's autoencoder needs: the synthesis of a T-frame
    utterance (masked features after it) in a bucket of T + reach frames
    equals that in a bucket 64 frames longer, and in a bucket of T frames it
    does not (the decoder's activations over padded frames are not its
    convs' zero padding)."""
    from msmctts_tpu.tasks import load_frozen_autoencoder as j_load_frozen_autoencoder

    _, task = _tasks(lj_pair["am"])
    reach = task.padding_reach_frames()
    assert reach >= t_receptive_field_frames(LJ_DECODER) == j_receptive_field_frames(LJ_DECODER)
    ae, av, _ = j_load_frozen_autoencoder(lj_pair["ae"])
    T, full = 40, 128
    mel = np.random.default_rng(6).normal(size=(1, full, MEL_DIM)).astype(np.float32)
    analysis = jax.jit(lambda m, n: ae.apply(av, m, n, method="analysis"))  # eager flax dispatches op by op
    jit_synthesis = jax.jit(lambda st, n: ae.apply(av, st, n, method="synthesis"))
    outs = [np.asarray(x) for x in _jax(lambda: analysis(mel, np.array([full], np.int32)))["quantizer_outputs"]]
    scales = [full // o.shape[1] for o in outs]
    assert scales == [4, 1]

    def synthesis(frames):
        frames = -(-frames // 4) * 4
        stages = []
        for o, s in zip(outs, scales):
            x = np.zeros((1, frames // s, o.shape[2]), np.float32)
            x[:, : T // s] = o[:, : T // s]
            stages.append(x)
        lengths = [np.array([T // s], np.int32) for s in scales]
        return np.asarray(_jax(lambda: jit_synthesis(stages, lengths)))[0, : T * HOP, 0]

    near, far, bare = synthesis(T + reach), synthesis(T + reach + 64), synthesis(T)
    np.testing.assert_allclose(near, far, atol=REACH_TOL, rtol=0)
    assert float(np.abs(bare - far).max()) > 100 * REACH_TOL


# ------------------------------------------------------ one step of each phase


@pytest.fixture(scope="module")
def lj_parity(tmp_path_factory):
    """One warmup and one GAN step of the tiny LJSpeech-geometry AE in both
    stacks from one JAX init (as ``test_torch_train_slice.parity``), on a
    seeded batch of 4 utterances of 12-24 frames (3 072-6 144 samples)."""
    d = str(tmp_path_factory.mktemp("lj_train"))
    config = _no_dropout(_lj_ae_config(d))
    config["trainer"]["warmup_steps"] = 1
    rng = np.random.default_rng(5)
    lengths = np.array([24, 20, 17, 12], np.int32)
    T = int(lengths.max())
    valid = np.arange(T)[None] < lengths[:, None]
    batch = {"mel": np.where(valid[..., None], rng.normal(size=(4, T, MEL_DIM)), -4.0).astype(np.float32),
             "mel_length": lengths,
             "wav": (rng.normal(size=(4, T * HOP)) * 0.1 * np.repeat(valid, HOP, axis=1)).astype(np.float32)}
    with jax.default_matmul_precision("highest"):
        jtask = build_task(config, mode="train")
        jtrainer = get_trainer("VQGANTrainer")(config, jtask, mesh=make_mesh(1), **component_kwargs(config.trainer))
        state = jtrainer.init_state(jax.random.PRNGKey(0), batch)
        state0 = jax.device_get(state)
        ae_log, d_log = [], []
        jtrainer.ae_tx, jtrainer.d_tx = _recording(jtrainer.ae_tx, ae_log), _recording(jtrainer.d_tx, d_log)
        j_states, j_metrics, starts = {0: state0}, {}, {}
        for it in (1, 2):
            state, m = jtrainer.train_step(state, batch, it)
            j_states[it] = jax.device_get(state)
            j_metrics[it] = m.to_host()
            jax.effects_barrier()
        r_win, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(jtrainer.seed), np.uint32(2)))
        maxval = np.maximum(lengths - jtrainer.frame_lengths, 1)
        starts[2] = np.asarray(jax.random.randint(r_win, (4,), 0, maxval))
    j_grads = {1: {"autoencoder": ae_log[0]}, 2: {"autoencoder": ae_log[1], "discriminator": d_log[0]}}

    trainer = _port_trainer(config.to_dict())
    assert trainer.ae.frameshift_ratio == HOP and [p[1] for p in trainer.disc.mrd.plans] == LJ_HOPS
    assert trainer.disc.mrd.sample_rate == SR
    W.train_state_from_jax(state0, trainer.ae, trainer.disc)
    t_batch = to_device(batch, "cpu")
    t_metrics, t_grads = {}, {}
    zeros = {k: np.zeros(tuple(v.shape), np.float32) for k, v in trainer.ae.state_dict().items()}
    for it in (1, 2):
        ae_step, d_step = trainer.ae_opt.step, trainer.d_opt.step
        seen = {}
        snap = lambda m: {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
                          for k, p in m.named_parameters()}
        trainer.d_opt.step = lambda: (seen.update(d=snap(trainer.disc)), d_step())
        trainer.ae_opt.step = lambda: (seen.update(ae=snap(trainer.ae)), ae_step())
        s = torch.tensor(starts[it]) if it in starts else None
        t_metrics[it] = {k: float(v) for k, v in trainer.train_step(t_batch, it, starts=s).items()}
        trainer.ae_opt.step, trainer.d_opt.step = ae_step, d_step
        g = {"autoencoder": W.msmc_vqgan_to_jax({**zeros, **seen["ae"]})["params"]}
        if "d" in seen:
            g["discriminator"] = W.univnet_discriminator_to_jax(seen["d"], periods=trainer.disc.mpd.periods)
        t_grads[it] = g
    return dict(j_states=j_states, j_metrics=j_metrics, j_grads=j_grads, trainer=trainer, t_metrics=t_metrics,
                t_grads=t_grads)


@pytest.mark.parametrize("it", [1, 2], ids=["warmup", "gan"])
def test_ljspeech_step_metrics_match_jax(lj_parity, it):
    got, want = lj_parity["t_metrics"][it], lj_parity["j_metrics"][it]
    assert sorted(got) == sorted(want)
    assert ("d_loss" in got) == (it == 2)
    for k in want:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL, abs=1e-6), (k, got[k], want[k])


@pytest.mark.parametrize("it,module", [(1, "autoencoder"), (2, "discriminator"), (2, "autoencoder")],
                         ids=["warmup-autoencoder", "gan-discriminator", "gan-autoencoder"])
def test_ljspeech_step_gradients_match_jax(lj_parity, it, module):
    got, want = _flat(lj_parity["t_grads"][it][module]), _flat(lj_parity["j_grads"][it][module])
    assert sorted(got) == sorted(want)
    live = 0
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=GRAD_RTOL * scale + 1e-7, err_msg=k)
        live += scale > 0
    reached = [k for k in want if not (it == 1 and k.startswith("decoder/"))]
    if it == 1:  # the warmup graph never reaches the waveform decoder
        assert all(float(np.abs(want[k]).max()) == 0.0 for k in want if k.startswith("decoder/"))
    assert live > len(reached) // 2


@pytest.mark.parametrize("module,steps", [("autoencoder", 2), ("discriminator", 1)])
def test_ljspeech_state_matches_jax_after_the_steps(lj_parity, module, steps):
    trainer, final = lj_parity["trainer"], lj_parity["j_states"][2]
    state = W.train_state_to_jax(trainer.ae, trainer.disc)
    if module == "autoencoder":
        for stage, node in final["codebook"]["quantizer"].items():
            for key in ("embed", "cluster_size", "embed_avg"):
                np.testing.assert_allclose(state["codebook"]["quantizer"][stage][key], node[key], rtol=CODEBOOK_TOL,
                                           atol=CODEBOOK_TOL, err_msg=f"{stage}.{key}")
    got, want = _flat(state["params"][module]), _flat(final["params"][module])
    assert sorted(got) == sorted(want)
    far = total = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * LR * steps + 1e-6, err_msg=k)
        far += int((np.abs(got[k] - want[k]) > 1e-5).sum())
        total += want[k].size
    assert far <= 0.002 * total, (far, total)


# ------------------------------------------------------ the shipped recipes


@pytest.mark.parametrize("recipe", ["msmc_vq_gan.yaml", "msmc_vq_gan_am.yaml"])
def test_shipped_ljspeech_recipes_build_for_training(recipe):
    cfg = TConfig(os.path.join(LJ_DIR, recipe))
    task = t_build_task(cfg, device="cpu", mode="train")
    assert task.samplerate == SR
    if recipe == "msmc_vq_gan.yaml":
        ae, disc = task.networks["autoencoder"], task.networks["discriminator"]
        assert ae.frameshift_ratio == HOP and ae.decoder_config["upsample_rates"] == [8, 8, 2, 2]
        assert [p[1] for p in disc.mrd.plans] == LJ_HOPS and disc.mrd.sample_rate == SR
        n = sum(p.numel() for p in ae.parameters())
        assert 1e7 < n < 1e8
    else:
        pred = task.networks["predictor"]
        assert list(pred.n_symbols) == [256] and "autoencoder" not in task.networks  # frozen, loaded lazily
        n = sum(p.numel() for p in pred.parameters())
        assert 1e7 < n < 2e8
