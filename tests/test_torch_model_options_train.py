"""The autoencoder's train steps with the model options no shipped recipe
sets (quantizer ``norm: True``, ``upsampling: residual``, ``restart_dead``),
in the port against msmctts_tpu on the CPU, and two ranks against one.

From one JAX ``init_state`` carried across by ``train_state_from_jax`` (its
counts raised to 1 so that no codeword dies: the restart draws, which
follow each stack's own generator, then change nothing), the same batch,
dropout 0 and the window starts JAX drew, 2 warmup + 2 GAN steps of the tiny
recipe run in both stacks: every metric, the codebook, the quantizer's
``batch_stats`` and the parameters after the last step; the checkpoint
carries the statistics to both packages' inference. Then 2 ranks over gloo
against one rank from the port's seeded init, where restarts do fire and
the batch norms reduce over the global batch.

Tolerances, as ``tests/test_torch_train_slice.py`` holds the recipe's
options: metrics 2e-5 relative; codebook 2e-5; batch statistics 1e-5 after
the first step (a moving average of means over a few hundred frames, on
equal weights) and 2 * lr * steps after the last (observed 1.5e-4: the
statistics of weights that Adam may part by 2 * lr a step); parameters
2 * lr * steps with at most 0.2 % of a module's entries beyond 1e-5, the
bias that a batch norm cancels left out of that share (see ``CANCELLED``). Two ranks
against one: 2e-4 relative on metrics, 2e-3 / 2e-4 on the state (the
global sums are added in another order), the restarted codewords' count per
step equal.
"""

import re

import jax
import numpy as np
import pytest
import torch

from msmctts_tpu.config import Config, component_kwargs
from msmctts_tpu.data.loader import DataLoader as JDataLoader
from msmctts_tpu.parallel.mesh import make_mesh
from msmctts_tpu.registry import get_trainer
from msmctts_tpu.tasks import build_task
from msmctts_tpu.training.base_trainer import build_dataset_from_config as j_build_dataset
from msmctts_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.data.loader import to_device
from msmctts_tpu_torch.parallel.launch import run_ranks
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint
from tests import torch_parallel_workers as workers
from tests.test_torch_model_options import _close, _np_tree, _same_tree
from tests.test_torch_train_slice import _flat, _no_dropout, _port_trainer
from tests.tiny import tiny_ae_config, write_tiny_dataset

torch.set_num_threads(2)

LR = 2e-4
STEPS = 4  # 2 warmup + 2 GAN
METRIC_RTOL = 2e-5
CODEBOOK_TOL = 2e-5
STATS_TOL = 1e-5
# the bias of the conv before each affine-free batch norm: the norm removes
# it, so its gradient is rounding noise in both stacks, which Adam turns
# into steps of about lr (observed: 31 of its 32 entries beyond 1e-5, up to
# 9.7e-4); it is held to the 2 * lr * steps bound only
CANCELLED = re.compile(r"quantizer/pre_\d+_b/bias")
CANCELLED_PORT = re.compile(r"quantizer\.preprocessor\.\d+\.2\.bias")
NO_DEATH = 0.5  # counts start at 1 and fall by at most 0.99 a step
FIRES = 0.05  # from the seeded init's zero counts: a codeword with < 5 of a step's frames restarts


def _options(config, restart_dead):
    q = config["task"]["autoencoder"]["quantizer_config"]
    q.update(norm=True, upsampling="residual", restart_dead=restart_dead)
    return config


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("options_train_corpus"))
    write_tiny_dataset(d, n_utts=8)
    return d


@pytest.fixture(scope="module")
def parity(corpus):
    config = _options(_no_dropout(tiny_ae_config(corpus)), NO_DEATH)
    config["save_checkpoint_dir"] = corpus + "/ckpt_parity"
    with jax.default_matmul_precision("highest"):
        jtask = build_task(config, mode="train")
        jtrainer = get_trainer("VQGANTrainer")(config, jtask, mesh=make_mesh(1), **component_kwargs(config.trainer))
        batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0)))
        batch = {k: batch[k] for k in ("mel", "mel_length", "wav")}
        state = jax.device_get(jtrainer.init_state(jax.random.PRNGKey(0), batch))
        for node in state["codebook"]["quantizer"].values():
            node["cluster_size"] = np.ones_like(node["cluster_size"])
        state0 = jax.tree_util.tree_map(np.asarray, state)
        j_states, j_metrics, starts = {0: state0}, {}, {}
        for it in range(1, STEPS + 1):
            state, m = jtrainer.train_step(state, batch, it)
            j_states[it] = jax.device_get(state)
            j_metrics[it] = m.to_host()
            if it > jtrainer.warmup_steps:
                r_win, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(jtrainer.seed), np.uint32(it)))
                maxval = np.maximum(batch["mel_length"].astype(np.int32) - jtrainer.frame_lengths, 1)
                starts[it] = np.asarray(jax.random.randint(r_win, (4,), 0, maxval))
    trainer = _port_trainer(config.to_dict())
    W.train_state_from_jax(state0, trainer.ae, trainer.disc)
    t_batch = to_device(batch, "cpu")
    t_metrics, t_stats = {}, {}
    for it in range(1, STEPS + 1):
        s = torch.tensor(starts[it]) if it in starts else None
        t_metrics[it] = {k: float(v) for k, v in trainer.train_step(t_batch, it, starts=s).items()}
        t_stats[it] = W.train_state_to_jax(trainer.ae, trainer.disc)["model_state"]["batch_stats"]
    return dict(config=config, batch=batch, j_states=j_states, j_metrics=j_metrics, trainer=trainer,
                t_metrics=t_metrics, t_stats=t_stats, jtrainer=jtrainer)


@pytest.mark.parametrize("it", [1, 2, 3, 4], ids=["warmup-1", "warmup-2", "gan-3", "gan-4"])
def test_option_step_metrics_match_jax(parity, it):
    got, want = parity["t_metrics"][it], parity["j_metrics"][it]
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL, abs=1e-6), (k, got[k], want[k])


def test_option_codebook_and_batch_stats_match_jax(parity):
    trainer, final, start = parity["trainer"], parity["j_states"][STEPS], parity["j_states"][0]
    got = W.train_state_to_jax(trainer.ae, trainer.disc)
    for stage, node in final["codebook"]["quantizer"].items():
        for key in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(got["codebook"]["quantizer"][stage][key], node[key], rtol=CODEBOOK_TOL,
                                       atol=CODEBOOK_TOL, err_msg=f"{stage}.{key}")
        assert not np.any(node["cluster_size"] == 1.0)  # nothing restarted
    # after the first step (whose forward ran on equal weights) to STATS_TOL;
    # after the last, the statistics of weights that may part by 2 * lr a
    # step are held as those weights are
    for it, tol in ((1, STATS_TOL), (STEPS, 2 * LR * STEPS)):
        stats = parity["j_states"][it]["model_state"]["batch_stats"]["quantizer"]
        mine = parity["t_stats"][it]["quantizer"]
        assert sorted(mine) == sorted(stats) == ["prenorm_0", "prenorm_1"]
        for stage, node in stats.items():
            for key in ("mean", "var"):
                np.testing.assert_allclose(mine[stage][key], node[key], rtol=tol, atol=tol,
                                           err_msg=f"step {it} {stage}.{key}")
                assert not np.allclose(node[key], start["model_state"]["batch_stats"]["quantizer"][stage][key])


@pytest.mark.parametrize("module,steps", [("autoencoder", 4), ("discriminator", 2)])
def test_option_parameters_match_jax_after_the_last_step(parity, module, steps):
    trainer = parity["trainer"]
    got = _flat(W.train_state_to_jax(trainer.ae, trainer.disc)["params"][module])
    want = _flat(parity["j_states"][STEPS]["params"][module])
    assert sorted(got) == sorted(want)
    if module == "autoencoder":
        assert {"quantizer/up_0/v", "quantizer/up_1/v"} <= set(want)
    far = total = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * LR * steps + 1e-6, err_msg=k)
        if CANCELLED.fullmatch(k):
            continue
        far += int((np.abs(got[k] - want[k]) > 1e-5).sum())
        total += want[k].size
    assert far <= 0.002 * total, (far, total)


def test_option_checkpoint_carries_the_batch_stats_to_both_packages(parity, tmp_path):
    """The trainer's checkpoint keeps ``model_state.batch_stats``; the
    port's and the JAX package's inference tasks load it, and their
    analysis-synthesis (which normalizes with the running statistics)
    agrees."""
    trainer = parity["trainer"]
    trainer.iteration = STEPS
    trainer.save_dir = str(tmp_path)
    path = trainer.save()
    stats = load_checkpoint(path)["state"]["model_state"]["batch_stats"]["quantizer"]
    np.testing.assert_array_equal(stats["prenorm_1"]["var"],
                                  trainer.ae.quantizer.preprocessor[1][3].running_var.numpy())
    batch = {k: parity["batch"][k] for k in ("mel", "mel_length")}
    ck = j_load_checkpoint(path)
    jtask = build_task(Config(ck["config"]), mode="infer")
    jtask.load_variables(ck["state"])
    with jax.default_matmul_precision("highest"):
        want = jtask.infer_step(batch)["wav"]
    ttask = t_build_task(TConfig(ck["config"]), device="cpu")
    ttask.load_variables(load_checkpoint(path)["state"])
    np.testing.assert_array_equal(ttask.networks["autoencoder"].quantizer.preprocessor[0][3].running_mean.numpy(),
                                  stats["prenorm_0"]["mean"])
    got = ttask.infer_step(batch)["wav"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4)


# ------------------------------------------------------------- two ranks


@pytest.fixture(scope="module")
def restart_runs(corpus):
    config = _options(tiny_ae_config(corpus), FIRES)
    batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=8, num_workers=0)))
    batch = {k: batch[k] for k in ("mel", "mel_length", "wav")}
    trainer = workers.build_trainer(config.to_dict(), {})
    trainer.init_state()
    state = {"autoencoder": W.state_dict_numpy(trainer.ae), "discriminator": W.state_dict_numpy(trainer.disc)}
    one = workers.run_restart_steps(trainer, batch, list(range(1, STEPS + 1)))
    two = run_ranks(workers.restart_steps_rank, 2, "gloo", ["cpu"] * 2, config.to_dict(), state, batch,
                    list(range(1, STEPS + 1)), timeout_s=240, threads=2)
    return one, two, state


def test_two_ranks_restart_and_normalize_as_one_rank(restart_runs):
    """Restarts fire in the first step (some codewords, not all), at the
    same codewords with the same rows on 2 ranks as on one: each rank fills
    the seeds of its rows and one all-reduce sums them; the batch norms
    normalize and move their statistics with the global batch's."""
    one, two, state0 = restart_runs
    n_stages = 2
    first = one["restarted"][:n_stages]
    assert all(0 < r < 2 * 8 for r in first), first  # 2 heads x 8 codewords a stage
    assert two[0]["restarted"] == two[1]["restarted"] == one["restarted"]
    for it, (m1, m2) in enumerate(zip(one["metrics"], two[0]["metrics"]), 1):
        assert sorted(m1) == sorted(m2)
        for k in m1:
            np.testing.assert_allclose(m2[k], m1[k], rtol=2e-4, atol=1e-5, err_msg=f"step {it} {k}")
    assert two[0]["deviation"] == 0.0 and two[1]["deviation"] == 0.0
    for module in ("autoencoder", "discriminator"):
        for k, v in one["state"][module].items():
            # the bias a batch norm cancels moves by noise (see CANCELLED)
            tol = dict(rtol=0, atol=2 * LR * STEPS) if CANCELLED_PORT.fullmatch(k) else dict(rtol=2e-3, atol=2e-4)
            np.testing.assert_allclose(two[0]["state"][module][k], v, err_msg=k, **tol)
    norm_keys = [k for k in one["state"]["autoencoder"] if k.endswith(".3.running_var")]
    assert len(norm_keys) == 2
    for k in norm_keys:
        assert not np.allclose(one["state"]["autoencoder"][k], state0["autoencoder"][k])
    np.testing.assert_array_equal(two[0]["rng"], one["rng"])


# ------------------------------------------------------------- the emb family


def test_emb_autoencoder_with_the_options_matches_jax():
    """The same ``quantizer_config`` reaches ``MSMCVQGANEmb``: with
    ``norm: True`` and ``residual`` upsampling, the port's copy through
    ``emb_autoencoder_from_jax`` (``up_i`` and the quantizer's ``prenorm_i``
    beside ECAPA's batch statistics) decodes as JAX's in eval, and
    ``emb_autoencoder_to_jax`` gives the tree back bit for bit."""
    from msmctts_tpu.models.msmc_vqgan_emb import MSMCVQGANEmb as JEmb
    from msmctts_tpu_torch.registry import get_network as t_get_network
    from tests.test_torch_emb_models import AE as EMB_AE, _inputs, _perturb, _port_kwargs, _torch_inputs

    rng = np.random.default_rng(9)
    node = {k: (dict(v) if isinstance(v, dict) else v) for k, v in EMB_AE.items() if not k.startswith("_")}
    node["quantizer_config"] = dict(node["quantizer_config"], norm=True, upsampling="residual")
    inp = _inputs(rng)
    jmod = JEmb(**node)
    v = _np_tree(jax.jit(lambda k, i: jmod.init({"params": k, "dropout": k}, **i))(jax.random.PRNGKey(0), inp))
    v["params"] = _perturb(v["params"], rng)
    v["batch_stats"] = _perturb(v["batch_stats"], rng)
    assert sorted(v["batch_stats"]["quantizer"]) == ["prenorm_0", "prenorm_1"]
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, i: jmod.apply(v, **i))(v, inp)
    port = t_get_network("MSMCVQGANEmb")(**_port_kwargs(node)).eval()
    W.load_numpy_state(port, W.emb_autoencoder_from_jax(v))
    with torch.inference_mode():
        got = port(**_torch_inputs(inp))
    for g, w in zip(got["encoder_indices"], want["encoder_indices"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _close(got["decoder_outputs"], want["decoder_outputs"], 1e-4)
    tree = W.emb_autoencoder_to_jax(W.state_dict_numpy(port))
    _same_tree(tree["batch_stats"], v["batch_stats"])
    _same_tree(tree["params"]["quantizer"], v["params"]["quantizer"])
