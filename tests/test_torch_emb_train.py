"""The port's QS-TTS training against msmctts_tpu, on the CPU.

Each step from the state the JAX trainer began it with, on the same batch,
with dropout 0 and the windows JAX drew: three steps of ``EmbVQGANTrainer``
on the tiny emb recipe (``tests/tiny.py::tiny_emb_config``: ECAPA global encoder, pitch and
energy, the adversarial prosody estimator) run in both stacks, one step in
each phase: supervised (step 1), decode without the discriminator (step 2,
``stft_loss_supervised_step: 2`` in a copy of the config) and GAN (step 3).
Then ``NASynEmbFSTrainer`` against the JAX-trained synthesizer as teacher,
2 ranks against 1 over gloo with a sub-batch of windows smaller than a
rank's rows, the checkpoint in both packages, and the ``train`` / ``infer``
entry points on the CPU.

Tolerances (fp32, JAX under matmul precision "highest"), those of the
earlier slices: metrics 2e-5 relative; codebook and batch-norm running
statistics 2e-5; parameters after the last step ``2 * lr * steps`` with at
most 0.2 % of the entries further than 1e-5 apart (Adam's first steps move
a weight by about ``lr`` whatever its gradient's size, so a gradient at
rounding level moves the two stacks apart by up to that; see
``test_torch_train_slice.py``); wav 1e-4.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from msmctts_tpu.config import Config as JConfig
from msmctts_tpu.config import component_kwargs
from msmctts_tpu.data.loader import DataLoader as JDataLoader
from msmctts_tpu.parallel.mesh import make_mesh
from msmctts_tpu.registry import get_trainer
from msmctts_tpu.tasks import build_task
from msmctts_tpu.training.base_trainer import build_dataset_from_config as j_build_dataset
from msmctts_tpu.utils.checkpoint import find_latest_checkpoint as j_find_latest
from msmctts_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.data.loader import to_device
from msmctts_tpu_torch.parallel.launch import run_ranks
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.utils.checkpoint import find_latest_checkpoint, load_checkpoint, save_checkpoint
from tests import torch_parallel_workers as workers
from tests.tiny import FRAMESHIFT, tiny_am_config, tiny_emb_config, write_tiny_emb_dataset

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 2e-4
STEPS = 3  # supervised, decode, GAN
PHASES = {1: (False, False), 2: (True, False), 3: (True, True)}  # iteration -> (decode, gan)
METRIC_RTOL = 2e-5
STATE_TOL = 2e-5
EMB_KEYS = ("emb", "emb_length", "pitch", "energy", "mel", "wav")
NASYN_KEYS = ("text", "text_length", "dur", "emb", "emb_length", "pitch", "energy")


def _emb_config(corpus, save_dir, dropout=False, sample_batch_size=None):
    """The tiny emb recipe with ``stft_loss_supervised_step: 2``, so that
    three steps cross the three phases; dropout 0 unless asked for."""
    config = tiny_emb_config(corpus)
    config["trainer"]["stft_loss_supervised_step"] = 2
    if sample_batch_size is not None:
        config["trainer"]["sample_batch_size"] = sample_batch_size
    config["save_checkpoint_dir"] = save_dir
    if not dropout:
        ae = config["task"]["autoencoder"]
        ae["encoder_config"]["dropout"] = ae["encoder_config"]["attn_dropout"] = 0.0
        ae["quantizer_config"]["dropout"] = 0.0
        ae["quantizer_config"]["prior_config"]["p_dropout"] = 0.0
    return config


def _nasyn_config(corpus, ae_ckpt, save_dir, dropout=False):
    """The tiny AM recipe as the QS-TTS predictor recipe is: emb (+ pitch,
    energy) features, ``NASynEmbFSTrainer``, the QS-TTS registry names."""
    config = tiny_am_config(corpus, ae_ckpt)
    config["task"]["_name"] = "NASynTTSv2"
    config["task"]["_mode"] = "train_predictor"
    config["task"]["predictor"]["_name"] = "NASynCascadeFastSpeech"
    config["task"]["predictor"]["n_pred_size"] = 16
    config["trainer"]["_name"] = "NASynEmbFSTrainer"
    config["dataset"]["feature"] = ["text", "dur", "emb", "pitch", "energy"]
    config["dataset"]["feature_path"] = [f"{corpus}/phone.txt", f"{corpus}/dur.txt", f"{corpus}/emb/{{}}.npy",
                                         f"{corpus}/pitch/{{}}.npy", f"{corpus}/energy/{{}}.npy"]
    config["dataset"]["dimension"] = [2, 1, 12, 1, 1]
    config["dataset"]["frameshift"] = [None, None, FRAMESHIFT, FRAMESHIFT, FRAMESHIFT]
    config["dataset"]["padding_value"] = [0, 0, 0, 0, 0]
    config["save_checkpoint_dir"] = save_dir
    if not dropout:
        p = config["task"]["predictor"]
        for node in (p["encoder_config"], p["decoder_config"]):
            node["dropout"] = 0.0
            node["attn_dropout"] = 0.0
        p["adaptor_config"]["dropout"] = 0.0
    return config


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_windows(jtrainer, batch, it):
    """The windows the JAX step of iteration ``it`` drew: (rows, starts)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(jtrainer.seed), np.uint32(it))
    r_win, r_sel, _ = jax.random.split(rng, 3)
    B = batch["emb"].shape[0]
    n_win = jtrainer.sample_batch_size
    rows = np.sort(np.asarray(jax.random.permutation(r_sel, B))[:n_win])
    maxval = np.maximum(batch["emb_length"][rows].astype(np.int32) - jtrainer.frame_lengths, 1)
    starts = np.asarray(jax.random.randint(r_win, (n_win,), 0, maxval))
    return rows, starts


def _close_trees(got, want, tol, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_emb_corpus"))
    write_tiny_emb_dataset(d)
    return d


@pytest.fixture(scope="module")
def parity(corpus):
    """Both stacks through the three phases from one init; the JAX trainer's
    checkpoint after them (the teacher of the predictor tests)."""
    config = _emb_config(corpus, corpus + "/ckpt_emb_jax")
    with jax.default_matmul_precision("highest"):
        jtask = build_task(config, mode="train")
        jtrainer = get_trainer("EmbVQGANTrainer")(config, jtask, mesh=make_mesh(1), **component_kwargs(config.trainer))
        batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0)))
        batch = {k: batch[k] for k in EMB_KEYS}
        state = jtrainer.init_state(jax.random.PRNGKey(0), batch)
        j_states, j_metrics, windows = {0: jax.device_get(state)}, {}, {}
        for it in range(1, STEPS + 1):
            state, m = jtrainer.train_step(state, batch, it)
            j_states[it] = jax.device_get(state)
            j_metrics[it] = m.to_host()
            if PHASES[it][0]:
                windows[it] = _jax_windows(jtrainer, batch, it)
        jtrainer.state, jtrainer.iteration = state, STEPS
        jtrainer.save()
    ae_ckpt = j_find_latest(config["save_checkpoint_dir"])

    # each step from the state JAX began it with (parameters, codebook, BN
    # statistics; the optimizers keep their own moments)
    trainer = workers.build_trainer(config.to_dict(), {})
    t_batch = to_device(batch, "cpu")
    t_metrics, t_states = {}, {}
    for it in range(1, STEPS + 1):
        trainer.load_state_tree(j_states[it - 1])
        t_metrics[it] = {k: float(v) for k, v in trainer.train_step(t_batch, it, windows=windows.get(it)).items()}
        t_states[it] = trainer.state_tree()
    return dict(config=config, batch=batch, j_states=j_states, j_metrics=j_metrics, windows=windows,
                trainer=trainer, t_metrics=t_metrics, t_states=t_states, jtrainer=jtrainer, ae_ckpt=ae_ckpt)


@pytest.mark.parametrize("it", [1, 2, 3], ids=["supervised-1", "decode-2", "gan-3"])
def test_emb_step_metrics_match_jax(parity, it):
    got, want = parity["t_metrics"][it], parity["j_metrics"][it]
    assert sorted(got) == sorted(want)
    decode, gan = PHASES[it]
    assert ("stft_loss" in got) == decode and ("d_loss" in got) == gan
    assert "d_prosody_loss" in got and "g_prosody_loss" in got
    for k in want:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL, abs=1e-6), (k, got[k], want[k])


@pytest.mark.parametrize("it", [1, 2, 3], ids=["supervised-1", "decode-2", "gan-3"])
def test_emb_codebook_and_batch_stats_match_jax(parity, it):
    """A codeword no frame has chosen holds its EMA sum over a cluster size
    near 0 (values up to ~2e5 in this run), so the codebook is held
    relatively there."""
    got, want = parity["t_states"][it], parity["j_states"][it]
    _close_trees(got["codebook"], want["codebook"], STATE_TOL, "codebook")
    _close_trees(got["model_state"]["batch_stats"], want["model_state"]["batch_stats"], STATE_TOL, "batch_stats")
    # the running statistics moved, by the biased batch variance (torch's unbiased one would not match)
    before = _flat(parity["j_states"][it - 1]["model_state"]["batch_stats"])
    after = _flat(want["model_state"]["batch_stats"])
    assert all(not np.array_equal(before[k], after[k]) for k in after)


@pytest.mark.parametrize("module,steps", [("autoencoder", 3), ("discriminator", 1), ("prosody_estimator", 3)])
def test_emb_parameters_match_jax_after_the_last_step(parity, module, steps):
    got = _flat(parity["t_states"][STEPS]["params"][module])
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


def test_emb_optimizer_counts_follow_the_phases(parity):
    trainer = parity["trainer"]
    assert (trainer.ae_opt.count, trainer.d_opt.count, trainer.pr_opt.count) == (3, 1, 3)
    again = workers.build_trainer(parity["config"].to_dict(), {})
    again.restart_optimizer_counts(3)
    assert (again.ae_opt.count, again.d_opt.count, again.pr_opt.count) == (3, 1, 3)


def test_drawn_windows_cover_the_sub_batch(parity):
    trainer = parity["trainer"]
    lengths = torch.as_tensor(parity["batch"]["emb_length"]).long()
    rows, u = trainer.draw_windows(4)
    assert rows.shape == (2,) and bool((rows[1:] > rows[:-1]).all()) and 0 <= int(rows.min()) and int(rows.max()) < 4
    local, starts, weights, n_win = trainer.local_windows(rows, u, lengths)
    assert torch.equal(local, rows) and n_win == 2 and torch.equal(weights, torch.ones(2))
    maxval = torch.clamp(lengths[rows] - trainer.frame_lengths, min=1)
    assert bool((starts >= 0).all()) and bool((starts < maxval).all())
    # a rank of two holding none of the drawn rows decodes one stand-in of weight 0
    trainer.rank, trainer.world = 1, 2
    try:
        local, starts, weights, n_win = trainer.local_windows(torch.tensor([0, 1]), u, lengths[:2])
    finally:
        trainer.rank, trainer.world = 0, 1
    assert local.tolist() == [0] and starts.tolist() == [0] and weights.tolist() == [0.0] and n_win == 2


def _redraw_gains(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _redraw_gains(v, rng)
        elif k == "g":
            tree[k] = rng.uniform(0.5, 1.5, size=np.shape(v)).astype(np.float32)


def test_emb_checkpoint_loads_into_both_packages(parity, tmp_path):
    trainer = parity["trainer"]
    trainer.save_dir = str(tmp_path)
    trainer.iteration = STEPS
    rng = np.random.default_rng(4)
    # the decoder's weight-norm gains redrawn in [0.5, 1.5]: a few steps from a seeded init leave the HiFi-GAN
    # near silence, where an absolute tolerance on the wav holds nothing
    saved = load_checkpoint(trainer.save())
    _redraw_gains(saved["state"]["params"]["autoencoder"]["decoder"], rng)
    path = str(tmp_path / "model_audible")
    save_checkpoint(path, saved["state"], saved["iteration"], saved["config"])
    T = 64
    batch = {"emb": rng.normal(size=(2, T, 12)).astype(np.float32), "emb_length": np.array([T, 40], np.int32),
             "pitch": rng.normal(size=(2, T, 1)).astype(np.float32), "energy": rng.normal(size=(2, T, 1)).astype(np.float32),
             "mel": rng.normal(size=(2, T, 8)).astype(np.float32)}
    ck = load_checkpoint(path)
    task = t_build_task(TConfig(ck["config"]), device="cpu")
    task.load_variables(ck["state"])
    got = task.infer_step(batch)
    jck = j_load_checkpoint(path)
    assert set(jck["state"]["params"]) == {"autoencoder", "discriminator", "prosody_estimator"}
    with jax.default_matmul_precision("highest"):
        jtask = build_task(JConfig(jck["config"]), mode="infer")
        jtask.load_variables(jck["state"])
        want = jtask.infer_step(batch)
    for a, b, n in zip(got["wav"], want["wav"], batch["emb_length"]):
        assert a.shape == (int(n) * FRAMESHIFT,)
        assert float(np.abs(a).max()) > 1e-2  # not a silent decoder
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)
    # and the JAX trainer's checkpoint (the teacher below) loads into the port
    jt = load_checkpoint(parity["ae_ckpt"])
    task.load_variables(jt["state"])
    _close_trees(W.emb_autoencoder_to_jax(W.state_dict_numpy(task.networks["autoencoder"]))["batch_stats"],
                 jt["state"]["model_state"]["batch_stats"], 0.0, "batch_stats")


@pytest.fixture(scope="module")
def nasyn(corpus, parity):
    """Two NASynEmbFSTrainer steps in both stacks against the JAX-trained
    synthesizer, from one JAX init."""
    config = _nasyn_config(corpus, parity["ae_ckpt"], corpus + "/ckpt_nasyn")
    with jax.default_matmul_precision("highest"):
        jtask = build_task(config, mode="train")
        jtrainer = get_trainer("NASynEmbFSTrainer")(config, jtask, mesh=make_mesh(1), **component_kwargs(config.trainer))
        loader = iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0))
        batches = [{k: b[k] for k in NASYN_KEYS} for b in (next(loader) for _ in range(2))]
        state = jtrainer.init_state(jax.random.PRNGKey(0), batches[0])
        state0 = jax.device_get(state)
        j_metrics = []
        for it, b in enumerate(batches, 1):
            state, m = jtrainer.train_step(state, b, it)
            j_metrics.append(m.to_host())
        j_final = jax.device_get(state)
    trainer = workers.build_trainer(config.to_dict(), {})
    trainer.load_state_tree(state0)
    teacher0 = {k: v.clone() for k, v in trainer.frozen_autoencoder().state_dict().items()}
    t_metrics = [{k: float(v) for k, v in trainer.train_step(to_device(b, "cpu"), it).items()}
                 for it, b in enumerate(batches, 1)]
    return dict(config=config, batches=batches, j_metrics=j_metrics, t_metrics=t_metrics, j_final=j_final,
                state0=state0, trainer=trainer, teacher0=teacher0)


def test_nasyn_steps_match_jax(nasyn):
    for it, (got, want) in enumerate(zip(nasyn["t_metrics"], nasyn["j_metrics"]), 1):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL, abs=1e-6), (it, k, got[k], want[k])
    # the teacher loaded lazily, in eval mode, and did not move
    ae = nasyn["trainer"].ae
    assert not ae.training and not any(p.requires_grad for p in ae.parameters())
    assert all(torch.equal(v, nasyn["teacher0"][k]) for k, v in ae.state_dict().items())


def _key_bias(name, cfg):
    """The entries of an attention's fused qkv bias that shift the keys (per
    head: q [d_k], k [d_k], v [d_v]), else none."""
    if not name.endswith("MultiHeadAttention_0/qkv/bias"):
        return slice(0, 0)
    d_k, d_v = cfg["d_k"], cfg["d_v"]
    idx = np.arange(cfg["n_head"] * (2 * d_k + d_v)) % (2 * d_k + d_v)
    return (idx >= d_k) & (idx < 2 * d_k)


def test_nasyn_parameters_match_jax(nasyn):
    """As for ``PredictorTrainer`` (``test_torch_am_train.py``): softmax over
    the keys cancels the attention's key bias, whose gradient is rounding
    noise in both stacks, turned by Adam into steps of about ``lr`` either
    way; it is held to ``2 * lr * steps`` and left out of the count."""
    cfg = nasyn["config"]["task"]["predictor"]["encoder_config"]
    got = _flat(nasyn["trainer"].state_tree()["params"]["predictor"])
    want = _flat(nasyn["j_final"]["params"]["predictor"])
    assert sorted(got) == sorted(want)
    far = total = noise = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * LR * 2 + 1e-6, err_msg=k)
        keys = np.zeros(want[k].shape, bool)
        keys[_key_bias(k, cfg)] = True
        noise += int(keys.sum())
        far += int(((np.abs(got[k] - want[k]) > 1e-5) & ~keys).sum())
        total += want[k].size
    assert noise == 3 * cfg["n_head"] * cfg["d_k"]  # the encoder's and both decoders' attention
    assert far <= 0.002 * total, (far, total)


@pytest.fixture(scope="module")
def emb_dp_runs(corpus):
    """Three steps (every phase) at global batch 4 with one window per step
    (``sample_batch_size: 1``: one rank holds no window) and the recipe's
    dropout on: one rank from a seeded state, then two ranks over gloo, each
    step from the state the one rank began it with. (Chained, the two runs
    part by more than rounding: at this init the waveform is mostly
    ``conv_post``'s bias, whose gradient under the log-mel loss is at
    rounding level, so Adam's first steps move it by about ``lr`` either
    way, and the next step's mel loss follows.)"""
    config = _emb_config(corpus, corpus + "/ckpt_emb_dp", dropout=True, sample_batch_size=1)
    batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0)))
    batch = {k: batch[k] for k in EMB_KEYS}
    trainer = workers.build_trainer(config.to_dict(), {})
    trainer.init_state()
    state = {name: W.state_dict_numpy(m) for name, m in trainer.task.networks.items()}
    one = workers.run_emb_steps(trainer, batch, STEPS)
    two = run_ranks(workers.emb_steps_rank, 2, "gloo", ["cpu"] * 2, config.to_dict(), state, batch, STEPS,
                    one["began"], timeout_s=240, threads=2)
    return one, two


def test_emb_two_ranks_match_one_rank(emb_dp_runs):
    one, two = emb_dp_runs
    assert two[0]["metrics"] == two[1]["metrics"]  # the global values, on every rank
    for it, (m1, m2) in enumerate(zip(one["metrics"], two[0]["metrics"]), 1):
        assert sorted(m1) == sorted(m2)
        for k in m1:
            np.testing.assert_allclose(m2[k], m1[k], rtol=2e-4, atol=1e-5, err_msg=f"step {it} {k}")
    # in each decoding step one rank decoded the drawn window and the other a stand-in of weight 0
    assert [sorted(w[it] for w in (two[0]["windows"], two[1]["windows"])) for it in (2, 3)] == [[0, 1], [0, 1]]
    assert two[0]["deviation"] == 0.0 and two[0]["rng"].tolist() == one["rng"].tolist()
    # after the last step: codebook and BN statistics to 1e-5; parameters one Adam step apart at most
    far = total = 0
    for name, sd in one["state"].items():
        for k, v in sd.items():
            got = two[0]["state"][name][k]
            if k.endswith(("embed", "embed_avg", "cluster_size", "running_mean", "running_var")):
                np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-5, err_msg=f"{name}.{k}")
            else:
                np.testing.assert_allclose(got, v, rtol=0, atol=2 * LR + 1e-6, err_msg=f"{name}.{k}")
                far += int((np.abs(got - v) > 1e-5).sum())
                total += v.size
    assert far <= 0.002 * total, (far, total)


def _write_cli_configs(corpus, tmp_path):
    emb = tiny_emb_config(corpus)
    emb["save_checkpoint_dir"] = str(tmp_path / "ckpt_emb")
    emb["save_features"] = [["wav", ".wav", 1600]]
    emb_path = str(tmp_path / "emb.yaml")
    with open(emb_path, "w") as f:
        yaml.safe_dump(emb.to_dict(), f)
    test_list = str(tmp_path / "test_emb.yaml")
    with open(test_list, "w") as f:
        yaml.safe_dump({u: {k: f"{corpus}/{k}/{u}.npy" for k in ("emb", "pitch", "energy", "mel")}
                        for u in ("utt000", "utt001", "utt002")}, f)
    return emb, emb_path, test_list


def test_train_and_infer_entry_points_on_cpu(corpus, tmp_path):
    emb, emb_path, test_list = _write_cli_configs(corpus, tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = lambda *args: subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env, capture_output=True,
                                       text=True, timeout=300)
    res = run("msmctts_tpu_torch.train", "-c", emb_path, "--device", "cpu", "--max-steps", "3", "--log-every", "1")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "step 3" in res.stdout and "d_prosody_loss" in res.stdout
    ckpt = find_latest_checkpoint(emb["save_checkpoint_dir"])
    assert ckpt.endswith("model_3")

    out = str(tmp_path / "out")
    res = run("msmctts_tpu_torch.infer", "-m", ckpt, "-t", test_list, "-o", out, "--device", "cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    from scipy.io import wavfile

    lengths = {u: np.load(f"{corpus}/emb/{u}.npy").shape[0] for u in ("utt000", "utt001", "utt002")}
    got = {u: wavfile.read(os.path.join(out, f"{u}_wav.wav"))[1].shape[0] for u in lengths}
    assert got == {u: n * FRAMESHIFT for u, n in lengths.items()} and len(set(got.values())) > 1

    # the predictor recipe's shape through the same entry point, against that checkpoint
    am = _nasyn_config(corpus, ckpt, str(tmp_path / "ckpt_nasyn"), dropout=True)
    am_path = str(tmp_path / "nasyn.yaml")
    with open(am_path, "w") as f:
        yaml.safe_dump(am.to_dict(), f)
    res = run("msmctts_tpu_torch.train", "-c", am_path, "--device", "cpu", "--max-steps", "2", "--log-every", "1")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "step 2" in res.stdout and "duration_loss" in res.stdout
    assert find_latest_checkpoint(am["save_checkpoint_dir"]).endswith("model_2")
