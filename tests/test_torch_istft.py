"""The port's ISTFT decoder family (``ops/stft.istft_real_imag``,
``models/hifigan.ISTFTGenerator`` / ``MSGenerator``, the decoder-family
aware ``generator_upsample_ratio``) against msmctts_tpu on the CPU, at the
shapes of ``tests/test_istft_generator.py``: the op and its gradients, both
generators in eval and train mode, the tiny autoencoder with an ISTFT
decoder (analysis-synthesis; 2 warmup + 2 GAN steps against the JAX trainer,
as ``test_torch_train_slice.py`` holds the HiFi-GAN recipe; checkpoints both
ways), a tiny acoustic model over it (predict, serving without streaming),
and the refusals the JAX package has.

Tolerances (fp32, JAX under matmul precision "highest").
  * ``istft_real_imag`` against JAX: 1e-6 of max(1, peak), on the output
    times its overlap-add normalizer where that is below 1 (the uncentred
    edges of a long window, where the division magnifies the sums'
    rounding; observed 1.2e-7 at unit amplitude);
    inverting the port's own ``stft_real_imag``: 5e-6 (observed 1.7e-6).
  * gradients: 1e-5 of the largest entry.
  * generators against flax: 1e-5 of the peak (observed 3e-8).
  * analysis-synthesis: indices equal, wav 1e-4 (as the HiFi-GAN recipe).
  * train steps: ``test_torch_train_slice.py``'s tolerances (metrics 2e-5
    relative, first-step gradients 1e-4 of the largest entry, codebook 2e-5,
    parameters 2 lr per step with at most 0.2 % of entries beyond 1e-5).
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from msmctts_tpu.config import Config
from msmctts_tpu.config import component_kwargs
from msmctts_tpu.data.loader import DataLoader as JDataLoader
from msmctts_tpu.models.hifigan import ISTFTGenerator as JISTFT
from msmctts_tpu.models.hifigan import MSGenerator as JMS
from msmctts_tpu.models.hifigan import generator_upsample_ratio as j_ratio
from msmctts_tpu.models.predictor import MultiStagePredictor
from msmctts_tpu.ops.stft import istft_real_imag as j_istft
from msmctts_tpu.ops.stft import stft_real_imag as j_stft
from msmctts_tpu.parallel.mesh import make_mesh
from msmctts_tpu.registry import get_network, get_trainer
from msmctts_tpu.tasks import build_task
from msmctts_tpu.training.base_trainer import build_dataset_from_config as j_build_dataset
from msmctts_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from msmctts_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.data.loader import to_device
from msmctts_tpu_torch.models.hifigan import ISTFTGenerator as TISTFT
from msmctts_tpu_torch.models.hifigan import MSGenerator as TMS
from msmctts_tpu_torch.models.hifigan import generator_upsample_ratio as t_ratio
from msmctts_tpu_torch.ops.stft import hann_window
from msmctts_tpu_torch.ops.stft import istft_real_imag as t_istft
from msmctts_tpu_torch.ops.stft import stft_real_imag as t_stft
from msmctts_tpu_torch.serving import BatchingEngine
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.utils.checkpoint import find_latest_checkpoint
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint as t_load_checkpoint
from tests.test_torch_slice import _gains
from tests.test_torch_train_slice import _flat, _no_dropout, _port_trainer, _recording
from tests.tiny import MEL_DIM, tiny_ae_config, tiny_am_config, tiny_emb_config, write_tiny_dataset

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRIES = [(40, 10, 40), (16, 4, 16), (1024, 300, 1024), (64, 16, 32)]
GEN_CFG = dict(resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], upsample_rates=[2],
               upsample_kernel_sizes=[4], upsample_initial_channel=16, num_mels=8)
ISTFT_DECODER = {"_name": "ISTFTGenerator", "upsample_rates": [2], "upsample_kernel_sizes": [4],
                 "upsample_initial_channel": 16, "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
                 "istft_hop": 2, "istft_n_fft": 8}
RATIO = 4  # 2 x istft_hop 2 = the tiny corpus's frameshift
LR = 2e-4
STEPS = 4  # 2 warmup + 2 GAN
METRIC_RTOL = 2e-5
GRAD_RTOL = 1e-4
CODEBOOK_TOL = 2e-5
WAV_TOL = 1e-4


def _jax(fn):
    with jax.default_matmul_precision("highest"):
        return fn()


# ------------------------------------------------------------ the op


@pytest.mark.parametrize("n_fft,hop,win", GEOMETRIES)
def test_istft_real_imag_matches_jax(n_fft, hop, win):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 1200)).astype(np.float32)
    r, i = (np.asarray(a) for a in _jax(lambda: j_stft(x, n_fft, hop, win, center=True)))
    # the overlap-add normalizer the output is divided by; where it is small
    # (the uncentred edges) the division magnifies the sums' rounding, so the
    # sums themselves (output x normalizer) are compared there
    wsq = np.zeros((r.shape[-1] - 1) * hop + n_fft)
    window = np.pad(hann_window(win) ** 2, ((n_fft - win) // 2, n_fft - win - (n_fft - win) // 2))
    for f in range(r.shape[-1]):
        wsq[f * hop: f * hop + n_fft] += window
    for center in (True, False):
        want = np.asarray(_jax(lambda: j_istft(r, i, n_fft, hop, win, center=center)))
        got = t_istft(torch.from_numpy(r), torch.from_numpy(i), n_fft, hop, win, center=center).numpy()
        assert got.shape == want.shape
        norm = np.minimum(wsq[n_fft // 2: wsq.size - n_fft // 2] if center else wsq, 1.0)
        np.testing.assert_allclose(got * norm, want * norm, atol=1e-6 * max(1.0, float(np.abs(want * norm).max())),
                                   rtol=0)


@pytest.mark.parametrize("n_fft,hop,win", GEOMETRIES)
def test_istft_inverts_the_ports_stft(n_fft, hop, win):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 1200)).astype(np.float32))
    r, i = t_stft(x, n_fft, hop, win, center=True)
    y = t_istft(r, i, n_fft, hop, win, center=True)
    T = min(x.shape[1], y.shape[1])
    np.testing.assert_allclose(y[:, :T].numpy(), x[:, :T].numpy(), atol=5e-6, rtol=0)


@pytest.mark.parametrize("n_fft,hop,center", [(40, 10, False), (16, 4, True)])
def test_istft_gradients_match_jax(n_fft, hop, center):
    rng = np.random.default_rng(1)
    bins = n_fft // 2 + 1
    r = rng.normal(size=(1, bins, 12)).astype(np.float32)
    i = rng.normal(size=(1, bins, 12)).astype(np.float32)
    w = rng.normal(size=(1, (12 - 1) * hop + n_fft - (n_fft if center else 0))).astype(np.float32)

    def loss(r, i):
        return (j_istft(r, i, n_fft, hop, n_fft, center=center) * w).sum() + (
            j_istft(r, i, n_fft, hop, n_fft, center=center) ** 2).sum()

    gr, gi = (np.asarray(g) for g in _jax(lambda: jax.grad(loss, argnums=(0, 1))(r, i)))
    tr, ti = torch.tensor(r, requires_grad=True), torch.tensor(i, requires_grad=True)
    y = t_istft(tr, ti, n_fft, hop, n_fft, center=center)
    ((y * torch.from_numpy(w)).sum() + (y ** 2).sum()).backward()
    for got, want in ((tr.grad.numpy(), gr), (ti.grad.numpy(), gi)):
        assert float(np.abs(want).max()) > 0
        np.testing.assert_allclose(got, want, atol=1e-5 * float(np.abs(want).max()), rtol=0)


# ------------------------------------------------------ the frame ratio


def _shipped_decoder_configs():
    """Every shipped recipe's autoencoder decoder config, and the trained
    fixture's."""
    out = {}
    for sub in ("csmsc", "ljspeech", "qs-tts"):
        for dirpath, _, files in os.walk(os.path.join(ROOT, "examples", sub, "configs")):
            for f in sorted(files):
                node = yaml.safe_load(open(os.path.join(dirpath, f)))["task"].get("autoencoder", {})
                if "decoder_config" in node:
                    out[f"{sub}/{f}"] = node["decoder_config"]
    fixture = t_load_checkpoint(os.path.join(ROOT, "tests", "fixtures", "csmsc_ae_r5.f16.ckpt"))
    out["fixture"] = fixture["config"]["task"]["autoencoder"]["decoder_config"]
    return out


RATIO_CASES = {
    "hifigan": {"upsample_rates": [6, 5, 5, 2]},
    "istft-by-name": {"_name": "ISTFTGenerator", "upsample_rates": [6, 5], "istft_hop": 10},
    "istft-by-key": {"upsample_rates": [2], "istft_hop": 2},
    "istft-default-hop": {"_name": "ISTFTGenerator", "upsample_rates": [6, 5]},
    **_shipped_decoder_configs(),
}


@pytest.mark.parametrize("name", sorted(RATIO_CASES))
def test_generator_upsample_ratio_matches_jax(name):
    cfg = RATIO_CASES[name]
    assert t_ratio(cfg) == j_ratio(cfg)
    if name == "csmsc/msmc_vq_gan_istft.yaml":
        assert t_ratio(cfg) == 300


# ------------------------------------------------------- the generators


def _gen_state(module, args, seed):
    v = jax.device_get(module.init(jax.random.PRNGKey(seed), *args))
    v["params"] = _gains(v["params"], np.random.default_rng(seed))
    return v


@pytest.fixture(scope="module")
def istft_gen():
    cfg = dict(GEN_CFG, istft_hop=2, istft_n_fft=8)
    x = np.random.default_rng(2).normal(size=(2, 24, 8)).astype(np.float32)
    g = JISTFT(**cfg)
    v = _gen_state(g, (x,), 0)
    port = TISTFT(**cfg)
    W.load_numpy_state(port, W.generator_from_jax(v["params"]))
    return dict(flax=g, v=v, port=port, x=x)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_istft_generator_matches_flax(istft_gen, mode):
    g, v, port, x = istft_gen["flax"], istft_gen["v"], istft_gen["port"], istft_gen["x"]
    want = np.asarray(_jax(lambda: g.apply(v, x)))
    port.train(mode == "train")
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 24 * RATIO, 1)
    peak = float(np.abs(want).max())
    assert peak > 1e-2  # not a near-silent decode
    np.testing.assert_allclose(got, want, atol=1e-5 * peak, rtol=0)
    # the weights cross back unchanged
    back = W.generator_to_jax(W.state_dict_numpy(port))
    for k, a in _flat(back).items():
        np.testing.assert_array_equal(a, _flat(v["params"])[k], err_msg=k)


def test_istft_generator_gradients_match_jax(istft_gen):
    """train(): the trunk's live weight norm, the spectral head and the
    iSTFT under autograd against ``jax.grad`` over the same parameters."""
    g, v, port, x = istft_gen["flax"], istft_gen["v"], istft_gen["port"], istft_gen["x"]
    jgrads = _jax(lambda: jax.grad(lambda p: (g.apply({"params": p}, x) ** 2).sum())(v["params"]))
    port.train()
    port.zero_grad()
    (port(torch.from_numpy(x)) ** 2).sum().backward()
    got = _flat(W.generator_to_jax({k: p.grad.numpy() for k, p in port.named_parameters()}))
    want = _flat(jax.device_get(jgrads))
    assert sorted(got) == sorted(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_RTOL * scale + 1e-7, rtol=0, err_msg=k)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_ms_generator_matches_flax(mode):
    cfg = dict(GEN_CFG, spk_dim=4)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 24, 8)).astype(np.float32)
    spk = rng.normal(size=(2, 4)).astype(np.float32)
    g = JMS(**cfg)
    v = _gen_state(g, (x, spk), 1)
    want = np.asarray(_jax(lambda: g.apply(v, x, spk)))
    port = TMS(**cfg).train(mode == "train")
    W.load_numpy_state(port, W.generator_from_jax(v["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(spk)).numpy()
    assert got.shape == want.shape == (2, 48, 1)
    peak = float(np.abs(want).max())
    assert peak > 1e-2
    np.testing.assert_allclose(got, want, atol=1e-5 * peak, rtol=0)
    assert sorted(_flat(W.generator_to_jax(W.state_dict_numpy(port)))) == sorted(_flat(v["params"]))


# ----------------------------------------------------- the autoencoder


def _istft_config(corpus):
    config = _no_dropout(tiny_ae_config(corpus))
    config["id"] = "tiny_ae_istft"
    config["task"]["autoencoder"]["decoder_config"] = dict(ISTFT_DECODER)
    config["save_checkpoint_dir"] = corpus + "/ckpt_istft"
    return config


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("istft_corpus"))
    write_tiny_dataset(d)
    return d


@pytest.fixture(scope="module")
def parity(corpus):
    """Both stacks through 2 warmup + 2 GAN steps of the tiny ISTFT recipe
    from one JAX init (as ``test_torch_train_slice.parity``)."""
    config = _istft_config(corpus)
    with jax.default_matmul_precision("highest"):
        jtask = build_task(config, mode="train")
        jtrainer = get_trainer("VQGANTrainer")(config, jtask, mesh=make_mesh(1), **component_kwargs(config.trainer))
        batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0)))
        batch = {k: batch[k] for k in ("mel", "mel_length", "wav")}
        state = jtrainer.init_state(jax.random.PRNGKey(0), batch)
        state0 = jax.device_get(state)
        ae_log, d_log = [], []
        jtrainer.ae_tx, jtrainer.d_tx = _recording(jtrainer.ae_tx, ae_log), _recording(jtrainer.d_tx, d_log)
        j_states, j_metrics, starts = {0: state0}, {}, {}
        for it in range(1, STEPS + 1):
            state, m = jtrainer.train_step(state, batch, it)
            j_states[it] = jax.device_get(state)
            j_metrics[it] = m.to_host()
            jax.effects_barrier()
            if it > jtrainer.warmup_steps:
                r_win, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(jtrainer.seed), np.uint32(it)))
                maxval = np.maximum(batch["mel_length"].astype(np.int32) - jtrainer.frame_lengths, 1)
                starts[it] = np.asarray(jax.random.randint(r_win, (4,), 0, maxval))
    j_grads = {1: {"autoencoder": ae_log[0]}, 3: {"autoencoder": ae_log[2], "discriminator": d_log[0]}}

    trainer = _port_trainer(config.to_dict())
    assert trainer.ae.frameshift_ratio == RATIO and type(trainer.ae.decoder).__name__ == "ISTFTGenerator"
    W.train_state_from_jax(state0, trainer.ae, trainer.disc)
    t_batch = to_device(batch, "cpu")
    t_metrics, t_grads = {}, {}
    zeros = {k: np.zeros(tuple(v.shape), np.float32) for k, v in trainer.ae.state_dict().items()}
    for it in range(1, STEPS + 1):
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
    return dict(config=config, batch=batch, j_states=j_states, j_metrics=j_metrics, j_grads=j_grads,
                trainer=trainer, t_metrics=t_metrics, t_grads=t_grads, jtrainer=jtrainer)


@pytest.mark.parametrize("it", [1, 2, 3, 4], ids=["warmup-1", "warmup-2", "gan-3", "gan-4"])
def test_istft_step_metrics_match_jax(parity, it):
    got, want = parity["t_metrics"][it], parity["j_metrics"][it]
    assert sorted(got) == sorted(want)
    assert ("d_loss" in got) == (it > 2)
    for k in want:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL, abs=1e-6), (k, got[k], want[k])


@pytest.mark.parametrize("it,module", [(1, "autoencoder"), (3, "discriminator"), (3, "autoencoder")],
                         ids=["warmup-autoencoder", "gan-discriminator", "gan-autoencoder"])
def test_istft_first_step_gradients_match_jax(parity, it, module):
    got, want = _flat(parity["t_grads"][it][module]), _flat(parity["j_grads"][it][module])
    assert sorted(got) == sorted(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=GRAD_RTOL * scale + 1e-7, err_msg=k)
    if it == 3 and module == "autoencoder":  # the GAN step reaches the spectral head
        assert float(np.abs(want["decoder/conv_post/v"]).max()) > 0


def test_istft_codebook_and_indices_match_jax(parity):
    trainer, final = parity["trainer"], parity["j_states"][STEPS]
    got = W.train_state_to_jax(trainer.ae, trainer.disc)["codebook"]["quantizer"]
    for stage, node in final["codebook"]["quantizer"].items():
        for key in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(got[stage][key], node[key], rtol=CODEBOOK_TOL, atol=CODEBOOK_TOL,
                                       err_msg=f"{stage}.{key}")
    batch, jt = parity["batch"], parity["jtrainer"]
    analysis = jax.jit(lambda v, m, l: jt.ae.apply(v, m, l, method="analysis"))
    q = _jax(lambda: analysis({"params": final["params"]["autoencoder"], "codebook": final["codebook"]},
                              batch["mel"], batch["mel_length"]))
    trainer.ae.eval()
    with torch.no_grad():
        tq = trainer.ae.analysis(torch.as_tensor(batch["mel"]), torch.as_tensor(batch["mel_length"]).long())
    trainer.ae.train()
    for a, b, n in zip(tq["quantizer_indices"], q["quantizer_indices"], q["quantizer_lengths"]):
        for row, (x, y) in enumerate(zip(a.numpy(), np.asarray(b))):
            np.testing.assert_array_equal(x[: int(n[row])], y[: int(n[row])])


@pytest.mark.parametrize("module,steps", [("autoencoder", 4), ("discriminator", 2)])
def test_istft_parameters_match_jax_after_the_last_step(parity, module, steps):
    trainer = parity["trainer"]
    got = _flat(W.train_state_to_jax(trainer.ae, trainer.disc)["params"][module])
    want = _flat(parity["j_states"][STEPS]["params"][module])
    start = _flat(parity["j_states"][0]["params"][module])
    assert sorted(got) == sorted(want)
    far = total = moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * LR * steps + 1e-6, err_msg=k)
        far += int((np.abs(got[k] - want[k]) > 1e-5).sum())
        total += want[k].size
        moved += int((want[k] != start[k]).sum())
    assert far <= 0.002 * total, (far, total)
    assert moved > 0.5 * total


def _ae_batch(seed=3):
    rng = np.random.default_rng(seed)
    return {"mel": rng.normal(size=(2, 16, MEL_DIM)).astype(np.float32), "mel_length": np.asarray([16, 12], np.int32)}


def test_jax_checkpoint_of_the_istft_recipe_loads_into_the_port(parity, tmp_path):
    """The JAX trainer's state after the GAN steps, as its checkpoint: the
    port's inference task reads it and its analysis-synthesis matches the
    JAX task's (indices equal, wav 1e-4, exactly 4 samples per frame)."""
    config, state = parity["config"], parity["j_states"][STEPS]
    path = str(tmp_path / "model_4")
    j_save_checkpoint(path, state, STEPS, config.to_dict())
    jck = j_load_checkpoint(path)
    jtask = build_task(Config(jck["config"]), mode="infer")
    jtask.load_variables(jck["state"])
    batch = _ae_batch()
    want = _jax(lambda: jtask.infer_step(batch))
    ck = t_load_checkpoint(path)
    task = t_build_task(TConfig(ck["config"]), device="cpu")
    task.load_variables(ck["state"])
    got = task.infer_step(batch)
    assert [w.shape for w in got["wav"]] == [(16 * RATIO,), (12 * RATIO,)]
    for a, b in zip(got["wav"], want["wav"]):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, np.asarray(b), atol=WAV_TOL, rtol=0)
    ae = task.networks["autoencoder"]
    with torch.no_grad():
        tq = ae.analysis(torch.from_numpy(batch["mel"]), torch.from_numpy(batch["mel_length"]).long())
    v = jtask.variables["autoencoder"]
    analysis = jax.jit(lambda v, m, l: jtask.networks["autoencoder"].apply(v, m, l, method="analysis",
                                                                           deterministic=True))
    jq = _jax(lambda: analysis(v, batch["mel"], batch["mel_length"]))
    for a, b in zip(tq["quantizer_indices"], jq["quantizer_indices"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_the_ports_istft_checkpoint_loads_into_jax(corpus, tmp_path):
    """The port's training loop on the ISTFT recipe (crossing warmup -> GAN),
    its checkpoint read by the JAX package's task: the same waveform."""
    config = _istft_config(corpus)
    config["save_checkpoint_dir"] = str(tmp_path / "ckpt")
    trainer = _port_trainer(config.to_dict())
    trainer.train(max_steps=3, log_every=1)
    path = find_latest_checkpoint(config["save_checkpoint_dir"])
    assert path.endswith("model_3") and trainer.d_opt.count == 1
    batch = _ae_batch(4)
    ck = t_load_checkpoint(path)
    task = t_build_task(TConfig(ck["config"]), device="cpu")
    task.load_variables(ck["state"])
    got = task.analysis_synthesis(batch)
    jck = j_load_checkpoint(path)
    jtask = build_task(Config(jck["config"]), mode="infer")
    jtask.load_variables(jck["state"])
    want = _jax(lambda: jtask.analysis_synthesis(batch))
    for a, b in zip(got["wav"], want["wav"]):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a, np.asarray(b), atol=WAV_TOL, rtol=0)


# ------------------------------------ an acoustic model over the ISTFT AE


@pytest.fixture(scope="module")
def istft_pair(tmp_path_factory):
    """A tiny ISTFT autoencoder and an acoustic model over it, initialised in
    JAX (weight-norm gains drawn in [0.5, 1.5]) and written as checkpoints."""
    from msmctts_tpu.utils.checkpoint import save_checkpoint

    d = str(tmp_path_factory.mktemp("istft_pair"))
    rng = np.random.default_rng(0)
    ae_cfg = tiny_ae_config(d)
    ae_cfg["task"]["autoencoder"]["decoder_config"] = dict(ISTFT_DECODER)
    node = ae_cfg.task["autoencoder"]
    ae = get_network(node["_name"])(**{k: v for k, v in node.items() if not k.startswith("_")})
    key = jax.random.PRNGKey(0)
    av = jax.device_get(jax.jit(lambda k: ae.init(
        {"params": k, "dropout": k}, np.zeros((1, 8, MEL_DIM), np.float32), np.array([8], np.int32),
        deterministic=True))(key))
    ae_path = os.path.join(d, "ae.ckpt")
    save_checkpoint(ae_path, {"params": {"autoencoder": _gains(av["params"], rng)}, "codebook": av["codebook"]}, 1,
                    ae_cfg.to_dict())
    am_cfg = tiny_am_config(d, ae_path)
    pnode = am_cfg.task["predictor"]
    pred = MultiStagePredictor(**{k: v for k, v in pnode.items() if not k.startswith("_")})
    pv = jax.jit(lambda k: pred.init(k, np.ones((1, 8, 2), np.int32), np.array([8], np.int32),
                                     dur=np.ones((1, 8), np.float32), max_frames=16))(key)
    pparams = MultiStagePredictor.bias_durations(jax.device_get(pv)["params"], 3.0)
    am_path = os.path.join(d, "am.ckpt")
    save_checkpoint(am_path, {"params": {"predictor": pparams}}, 1, am_cfg.to_dict())
    return {"ae": ae_path, "am": am_path}


def _tasks(path):
    jck = j_load_checkpoint(path)
    jtask = build_task(Config(jck["config"]), mode="infer")
    jtask.load_variables(jck["state"])
    ck = t_load_checkpoint(path)
    task = t_build_task(TConfig(ck["config"]), device="cpu")
    task.load_variables(ck["state"])
    return jtask, task


def _tts_batch():
    rng = np.random.default_rng(1)
    B, Lt = 3, 16
    text_length = np.array([11, 6, 16])
    valid = np.arange(Lt)[None] < text_length[:, None]
    text = np.stack([rng.integers(1, 20, (B, Lt)), rng.integers(0, 5, (B, Lt))], -1) * valid[..., None]
    return {"text": text.astype(np.int32), "text_length": text_length.astype(np.int32)}


def test_predict_over_an_istft_autoencoder_matches_jax(istft_pair):
    jtask, task = _tasks(istft_pair["am"])
    batch = _tts_batch()
    want = _jax(lambda: jtask.infer_step(batch))
    got = task.infer_step(batch)
    np.testing.assert_array_equal(got["duration"], np.asarray(want["duration"]))
    np.testing.assert_array_equal(got["mel_length"], np.asarray(want["mel_length"]))
    for a, b, n in zip(got["wav"], want["wav"], got["mel_length"]):
        assert a.shape == (int(n) * RATIO,)
        np.testing.assert_allclose(a, np.asarray(b), atol=WAV_TOL, rtol=0)
    assert max(float(np.abs(w).max()) for w in got["wav"]) > 1e-2


def test_the_refusals_of_the_jax_package(istft_pair):
    """Streaming and int8 cover the HiFi-GAN decoder only, in both packages;
    int8 covers the mel autoencoder only."""
    jtask, task = _tasks(istft_pair["am"])
    jtask.pre_infer()
    task.pre_infer()
    batch = _tts_batch()
    with pytest.raises(NotImplementedError, match="streaming"):
        _jax(lambda: jtask._streaming_decoder(4))
    with pytest.raises(NotImplementedError, match="streaming"):
        task.predict_stream(batch, chunk_frames=4)
    jtask.int8_decoder = task.int8_decoder = True
    with pytest.raises(NotImplementedError, match="HifiGANGenerator"):
        _jax(lambda: jtask.predict(batch))
    with pytest.raises(NotImplementedError, match="HifiGANGenerator"):
        task.predict(batch)
    _, ae_task = _tasks(istft_pair["ae"])
    ae_task.int8_decoder = True
    with pytest.raises(NotImplementedError, match="HifiGANGenerator"):
        ae_task.analysis_synthesis(_ae_batch())
    # int8 over an SSL-embedding autoencoder
    emb = t_build_task(TConfig(tiny_emb_config("/unused").to_dict()), device="cpu")
    emb.int8_decoder = True
    with pytest.raises(NotImplementedError, match="mel autoencoder"):
        emb.analysis_synthesis({"emb": np.zeros((1, 8, 12), np.float32), "emb_length": np.array([8], np.int32)})
    with pytest.raises(NotImplementedError, match="mel autoencoder"):
        emb._int8()


def test_an_istft_model_serves_through_the_monolithic_path(istft_pair):
    """The engine's automatic streaming warmup turns itself off over an ISTFT
    decoder (as the JAX engine's does); blocking requests are served on warm
    shapes and streaming requests are refused up front."""
    _, task = _tasks(istft_pair["am"])
    task.pre_infer()
    engine = BatchingEngine(task, sample_rate=1600, batch_size=2, text_length=16, max_frames=64)
    engine.start(warmup={"text_lengths": [8]})
    try:
        assert engine._warmed and not engine._streaming_warm
        wav = engine.synthesize("3_1 5_2 7_0 2_1", timeout=120)
        assert wav.ndim == 1 and wav.size % RATIO == 0 and np.isfinite(wav).all()
        with pytest.raises(RuntimeError, match="streaming shapes are cold"):
            list(engine.synthesize_stream("4_2 6_1", timeout=120))
        stats = engine.snapshot()
        assert stats["cold_shapes"] == 0 and stats["kernel_builds"] == 0
    finally:
        engine.stop()
