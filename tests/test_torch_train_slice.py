"""The port's training slice as a whole against msmctts_tpu, on the CPU.

From one JAX ``init_state`` carried across by ``train_state_from_jax``, the
same batch, dropout 0 in every config node and the window starts JAX drew,
2 warmup + 2 GAN steps of the tiny recipe run in both stacks: every metric
of every step, the gradients of the first step of each phase, the codebook
and the parameters after the last step. Then the port alone: the training
loop on the tiny corpus, its checkpoint (resumed, loaded by the port's
inference task and by the JAX package), the loaders' batch order, the CLI,
and the re-fold of weight norm on the way back to eval.

Tolerances (fp32, JAX under matmul precision "highest").
  * indices: equal.
  * metrics: 2e-5 relative (observed: up to 2.4e-6; sums and means over a
    few thousand fp32 terms taken in another order).
  * gradients of the first step of each phase (equal parameters on both
    sides in the warmup step, nearly equal in the GAN step): 1e-4 of the
    tensor's largest entry, plus 1e-7 (observed: up to 1.4e-5, behind the
    discriminator's conv stacks and the STFT).
  * codebook: 2e-5 (observed: up to 7.6e-6; an EMA of sums over the same
    assignments).
  * parameters after the last step: Adam divides the gradient by its own
    running magnitude, so in the first steps every weight moves by about
    ``lr`` whatever the gradient's size, and a weight whose gradient is at
    rounding-noise level (its sign differs between the stacks) can end up
    ``2 * lr`` apart per step with no fault anywhere. So each parameter is
    held to ``2 * lr * steps`` absolutely, and the share of entries further
    than 1e-5 apart to 0.2 % per module (observed: 5 of 21 530 in the
    autoencoder, none in the discriminator), which a wrong gradient or a
    wrong optimizer step could not meet: before the port's optimizer gave
    unreached parameters a zero gradient, as optax does, that share was 15 %.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from msmctts_tpu.config import component_kwargs
from msmctts_tpu.data.loader import DataLoader as JDataLoader
from msmctts_tpu.parallel.mesh import make_mesh
from msmctts_tpu.registry import get_trainer
from msmctts_tpu.tasks import build_task
from msmctts_tpu.training.base_trainer import build_dataset_from_config as j_build_dataset
from msmctts_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from msmctts_tpu_torch import train as t_train
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.config import component_kwargs as t_component_kwargs
from msmctts_tpu_torch.data.loader import DataLoader as TDataLoader
from msmctts_tpu_torch.data.loader import to_device
from msmctts_tpu_torch.registry import get_trainer as t_get_trainer
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.training.base_trainer import build_dataset_from_config as t_build_dataset
from msmctts_tpu_torch.utils.checkpoint import find_latest_checkpoint, load_checkpoint
from tests.tiny import FRAMESHIFT, tiny_ae_config, write_tiny_dataset

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 2e-4
STEPS = 4  # 2 warmup + 2 GAN
METRIC_RTOL = 2e-5
GRAD_RTOL = 1e-4
CODEBOOK_TOL = 2e-5


def _no_dropout(config):
    ae = config["task"]["autoencoder"]
    for node in (ae["encoder_config"], ae["frame_decoder_config"]):
        node["dropout"] = 0.0
        node["attn_dropout"] = 0.0
    ae["quantizer_config"]["dropout"] = 0.0
    ae["quantizer_config"]["prior_config"]["p_dropout"] = 0.0
    return config


def _port_trainer(config_dict, device="cpu"):
    cfg = TConfig(config_dict)
    task = t_build_task(cfg, device=device, mode="train")
    return t_get_trainer(cfg.trainer["_name"])(cfg, task, **t_component_kwargs(cfg.trainer))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _recording(tx, log):
    """``tx`` that also hands every gradient tree it is given to ``log``, from
    inside the trainer's jitted step (a host callback)."""

    def update(grads, state, params=None):
        jax.debug.callback(lambda g: log.append(jax.tree_util.tree_map(np.asarray, g)), grads)
        return tx.update(grads, state, params)

    return optax.GradientTransformation(tx.init, update)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_train_corpus"))
    write_tiny_dataset(d)
    return d


@pytest.fixture(scope="module")
def parity(corpus):
    """Both stacks through 2 warmup + 2 GAN steps from one init."""
    config = _no_dropout(tiny_ae_config(corpus))
    config["save_checkpoint_dir"] = corpus + "/ckpt_parity"
    with jax.default_matmul_precision("highest"):
        jtask = build_task(config, mode="train")
        jtrainer = get_trainer("VQGANTrainer")(config, jtask, mesh=make_mesh(1), **component_kwargs(config.trainer))
        batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0)))
        batch = {k: batch[k] for k in ("mel", "mel_length", "wav")}
        # flax's init runs a training forward: state0 already holds one EMA update
        state = jtrainer.init_state(jax.random.PRNGKey(0), batch)
        state0 = jax.device_get(state)  # the step donates its input state

        # the step's raw gradients, as its optimizers receive them
        ae_log, d_log = [], []
        jtrainer.ae_tx, jtrainer.d_tx = _recording(jtrainer.ae_tx, ae_log), _recording(jtrainer.d_tx, d_log)
        j_states, j_metrics, starts = {0: state0}, {}, {}
        for it in range(1, STEPS + 1):
            state, m = jtrainer.train_step(state, batch, it)
            j_states[it] = jax.device_get(state)
            j_metrics[it] = m.to_host()
            jax.effects_barrier()
            if it > jtrainer.warmup_steps:  # the windows the step drew
                r_win, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(jtrainer.seed), np.uint32(it)))
                maxval = np.maximum(batch["mel_length"].astype(np.int32) - jtrainer.frame_lengths, 1)
                starts[it] = np.asarray(jax.random.randint(r_win, (4,), 0, maxval))

    assert len(ae_log) == STEPS and len(d_log) == STEPS - jtrainer.warmup_steps
    j_grads = {1: {"autoencoder": ae_log[0]}, 3: {"autoencoder": ae_log[2], "discriminator": d_log[0]}}

    trainer = _port_trainer(config.to_dict())
    W.train_state_from_jax(state0, trainer.ae, trainer.disc)
    t_batch = to_device(batch, "cpu")
    t_metrics, t_grads = {}, {}
    zeros = {k: np.zeros(tuple(v.shape), np.float32) for k, v in trainer.ae.state_dict().items()}

    for it in range(1, STEPS + 1):
        ae_step, d_step = trainer.ae_opt.step, trainer.d_opt.step
        seen = {}
        # raw gradients, read just before each optimizer's update (the clip is inside it)
        # (a parameter the graph never reached has no gradient: zeros in JAX)
        snap = lambda m: {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy() for k, p in m.named_parameters()}
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
                starts=starts, trainer=trainer, t_metrics=t_metrics, t_grads=t_grads, jtrainer=jtrainer)


@pytest.mark.parametrize("it", [1, 2, 3, 4], ids=["warmup-1", "warmup-2", "gan-3", "gan-4"])
def test_step_metrics_match_jax(parity, it):
    got, want = parity["t_metrics"][it], parity["j_metrics"][it]
    assert sorted(got) == sorted(want)
    assert ("d_loss" in got) == (it > 2)
    for k in want:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL, abs=1e-6), (k, got[k], want[k])


@pytest.mark.parametrize("it,module", [(1, "autoencoder"), (3, "discriminator"), (3, "autoencoder")],
                         ids=["warmup-autoencoder", "gan-discriminator", "gan-autoencoder"])
def test_first_step_gradients_match_jax(parity, it, module):
    got, want = _flat(parity["t_grads"][it][module]), _flat(parity["j_grads"][it][module])
    assert sorted(got) == sorted(want)
    live = 0
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=GRAD_RTOL * scale + 1e-7, err_msg=k)
        live += scale > 0
    if it == 1:  # the warmup graph never reaches the waveform decoder
        assert all(float(np.abs(v).max()) == 0.0 for k, v in want.items() if k.startswith("decoder/"))
        assert "discriminator" not in parity["t_grads"][it]
    assert live > len(want) // 2


def test_codebook_and_indices_match_jax(parity):
    trainer, final = parity["trainer"], parity["j_states"][STEPS]
    got = W.train_state_to_jax(trainer.ae, trainer.disc)["codebook"]["quantizer"]
    for stage, node in final["codebook"]["quantizer"].items():
        for key in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(got[stage][key], node[key], rtol=CODEBOOK_TOL, atol=CODEBOOK_TOL, err_msg=f"{stage}.{key}")
        assert not np.allclose(node["embed"], parity["j_states"][0]["codebook"]["quantizer"][stage]["embed"])
    # the assignments both stacks make from the final state
    batch = parity["batch"]
    jt = parity["jtrainer"]
    with jax.default_matmul_precision("highest"):
        q = jt.ae.apply({"params": final["params"]["autoencoder"], "codebook": final["codebook"]},
                        batch["mel"], batch["mel_length"], method="analysis")
    trainer.ae.eval()
    with torch.no_grad():
        tq = trainer.ae.analysis(torch.as_tensor(batch["mel"]), torch.as_tensor(batch["mel_length"]).long())
    trainer.ae.train()
    for a, b, n in zip(tq["quantizer_indices"], q["quantizer_indices"], q["quantizer_lengths"]):
        for row, (x, y) in enumerate(zip(a.numpy(), np.asarray(b))):
            np.testing.assert_array_equal(x[: int(n[row])], y[: int(n[row])])


@pytest.mark.parametrize("module,steps", [("autoencoder", 4), ("discriminator", 2)])
def test_parameters_match_jax_after_the_last_step(parity, module, steps):
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
    assert moved > 0.5 * total  # the steps did move the weights


def test_training_loop_checkpoint_resumes_and_loads_everywhere(corpus, tmp_path):
    config = tiny_ae_config(corpus)
    config["save_checkpoint_dir"] = str(tmp_path / "ckpt")
    trainer = _port_trainer(config.to_dict())
    trainer.train(max_steps=4, log_every=2)
    path = find_latest_checkpoint(config["save_checkpoint_dir"])
    assert path is not None and path.endswith("model_4") and trainer.iteration == 4
    assert (trainer.ae_opt.count, trainer.d_opt.count) == (4, 2)  # D steps in the GAN phase only
    logs = [f for f in os.listdir(config["save_checkpoint_dir"]) if f.endswith(".log")]
    assert len(logs) == 1 and "step 4" in open(os.path.join(config["save_checkpoint_dir"], logs[0])).read()

    # resumes at iteration 4 with its optimizer state and generator, then goes on
    again = _port_trainer(config.to_dict())
    again.train(max_steps=1, log_every=1)
    assert again.iteration == 5 and (again.ae_opt.count, again.d_opt.count) == (5, 3)
    assert find_latest_checkpoint(config["save_checkpoint_dir"]).endswith("model_5")

    # the port's inference task loads it
    ckpt = load_checkpoint(path)
    assert ckpt["iteration"] == 4 and ckpt["config"]["task"]["_name"] == "MSMCTTS"
    infer = t_build_task(TConfig(ckpt["config"]), device="cpu")
    infer.load_variables(ckpt["state"])
    rng = np.random.default_rng(3)
    batch = {"mel": rng.normal(size=(2, 64, 8)).astype(np.float32), "mel_length": np.array([64, 40], np.int32)}
    got = infer.analysis_synthesis(batch)
    assert [w.shape for w in got["wav"]] == [(64 * FRAMESHIFT,), (40 * FRAMESHIFT,)]
    sd = infer.networks["autoencoder"].state_dict()
    for k, v in trainer.ae.state_dict().items():
        if not k.startswith("quantizer.quantizer."):  # `again` did not touch `trainer`
            assert torch.equal(sd[k], v), k

    # and the JAX package reads it and computes the same waveform from it
    from msmctts_tpu.config import Config

    jck = j_load_checkpoint(path)
    assert jck["iteration"] == 4 and "discriminator" in jck["state"]["params"]
    with jax.default_matmul_precision("highest"):
        jtask = build_task(Config(jck["config"]), mode="infer")
        jtask.load_variables(jck["state"])
        want = jtask.analysis_synthesis(batch)
    for a, b in zip(got["wav"], want["wav"]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)


def test_loaders_yield_equal_batches_in_equal_order(corpus):
    config = tiny_ae_config(corpus)
    jl = iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0, seed=1234))
    tl = iter(TDataLoader(t_build_dataset(TConfig(config.to_dict()), training=True), batch_size=4, num_workers=2, seed=1234))
    seen = set()
    for _ in range(5):
        a, b = next(jl), next(tl)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        seen.add(a["mel"].tobytes())
    tl.close()
    assert len(seen) > 1  # the order is a shuffle, not one batch repeated
    dev = to_device(b, "cpu")
    assert dev["mel"].dtype == torch.float32 and dev["mel_length"].dtype == torch.int64


def test_train_entry_point_on_cpu(corpus, tmp_path, monkeypatch):
    config = tiny_ae_config(corpus)
    config["save_checkpoint_dir"] = str(tmp_path / "ckpt_cli")
    cfg_path = str(tmp_path / "ae.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config.to_dict(), f)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-m", "msmctts_tpu_torch.train", "-c", cfg_path, "--device", "cpu", "--max-steps", "2",
         "--log-every", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "step 2" in res.stdout and os.path.exists(os.path.join(config["save_checkpoint_dir"], "model_2"))
    # without a GPU and without --device cpu it refuses to run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(["-c", cfg_path, "--max-steps", "1"])


def test_eval_after_a_train_step_uses_refolded_weights(corpus):
    config = _no_dropout(tiny_ae_config(corpus))
    trainer = _port_trainer(config.to_dict())
    trainer.init_state()
    batch = to_device(next(iter(TDataLoader(t_build_dataset(TConfig(config.to_dict())), batch_size=4, num_workers=0))), "cpu")
    ae = trainer.ae
    conv = ae.decoder.conv_pre
    ae.eval()
    stale = conv.weight.clone()
    stale_taps = ae.decoder.resblocks[0].taps1_0.clone()
    for it in (3, 4):  # GAN steps: the decoder's weights move
        trainer.train_step(batch, it + trainer.warmup_steps)
    assert ae.training
    ae.eval()
    from msmctts_tpu_torch.ops.convs import fold_weight_norm

    assert not torch.equal(conv.weight, stale) and not torch.equal(ae.decoder.resblocks[0].taps1_0, stale_taps)
    assert torch.equal(conv.weight, fold_weight_norm(conv.weight_v, conv.weight_g).detach())
    # eval (folded weights, fused resblock layers) and train mode (live weight
    # norm, convs under autograd) compute the same decoder
    feats = torch.randn(2, 16, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        folded = ae.decoder(feats)
        ae.train()
        live = ae.decoder(feats)
    torch.testing.assert_close(folded, live, rtol=1e-5, atol=1e-6)
    # the trainer's draws come from its own generator, not the global one
    state = torch.get_rng_state()
    trainer.train_step(batch, 5 + trainer.warmup_steps)
    assert torch.equal(torch.get_rng_state(), state)


def test_leaky_relu_takes_jax_slope_at_zero():
    """``models.hifigan.leaky_relu`` against ``jax.nn.leaky_relu``: the same
    values, and slope 1 at exactly 0 in the backward (``F.leaky_relu``'s
    backward takes the negative slope there)."""
    from msmctts_tpu_torch.models.hifigan import leaky_relu

    x = np.array([-2.0, -0.5, 0.0, -0.0, 0.5, 3.0], np.float32)
    want = np.asarray(jax.nn.leaky_relu(x, 0.2))
    want_grad = np.asarray(jax.grad(lambda v: jax.nn.leaky_relu(v, 0.2).sum())(x))
    t = torch.tensor(x, requires_grad=True)
    y = leaky_relu(t, 0.2)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want)
    np.testing.assert_array_equal(t.grad.numpy(), want_grad)
    assert want_grad[2] == 1.0
    with torch.no_grad():  # the one-kernel path of a pass without gradients
        np.testing.assert_array_equal(leaky_relu(torch.tensor(x), 0.2).numpy(), want)


def test_gan_step_over_padded_windows_matches_jax(corpus, capsys):
    """One GAN step whose windows reach into the batch's padding, from one
    JAX init (ROADMAP C2): the first batch of the tiny corpus (13-18 frames
    in the 64-frame bucket) with ``sample_lengths`` 256, so every window is
    the whole padded bucket from frame 0. The discriminators' zero-bias
    convs give exactly 0 over the zero-padded target, where the leaky ReLU's
    backward slope decides the discriminator's first update; with torch's
    slope there ``fm_loss`` was 1.8e-4 relative from JAX. Held to the train
    slice's METRIC_RTOL."""
    config = _no_dropout(tiny_ae_config(corpus))
    config["trainer"]["sample_lengths"] = 256
    config["trainer"]["warmup_steps"] = 0
    config["save_checkpoint_dir"] = corpus + "/ckpt_padded"
    with jax.default_matmul_precision("highest"):
        jtask = build_task(config, mode="train")
        jt = get_trainer("VQGANTrainer")(config, jtask, mesh=make_mesh(1), **component_kwargs(config.trainer))
        batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0)))
        batch = {k: batch[k] for k in ("mel", "mel_length", "wav")}
        assert batch["mel"].shape[1] == 64 and int(batch["mel_length"].max()) < 64
        state0 = jax.device_get(jt.init_state(jax.random.PRNGKey(0), batch))
        _, m = jt.train_step(jax.device_put(state0), batch, 1)
        want = m.to_host()
        r_win, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(jt.seed), np.uint32(1)))
        maxval = np.maximum(batch["mel_length"].astype(np.int32) - jt.frame_lengths, 1)
        starts = np.asarray(jax.random.randint(r_win, (4,), 0, maxval))
    assert (starts == 0).all()
    trainer = _port_trainer(config.to_dict())
    W.train_state_from_jax(state0, trainer.ae, trainer.disc)
    got = {k: float(v) for k, v in trainer.train_step(to_device(batch, "cpu"), 1, starts=torch.tensor(starts)).items()}
    assert sorted(got) == sorted(want) and "fm_loss" in got
    gaps = {k: abs(got[k] - float(want[k])) / max(abs(float(want[k])), 1e-12) for k in ("fm_loss", "adv_loss")}
    with capsys.disabled():
        print(f"\npadded windows, relative gap from JAX: {gaps}")
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL, abs=1e-6), (k, got[k], want[k])
