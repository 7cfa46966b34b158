"""Tensor parallelism of the port (``msmctts_tpu_torch/parallel/sharding.py``)
on the CPU: a data x model group of gloo ranks
(``parallel.launch.run_ranks``; rank functions in
``tests/torch_mesh_workers.py``) at the widths of ``tests/tiny.py``,
against one port process and against the JAX package's tensor-parallel run
(``tests/test_parallel.py::test_tensor_parallel_parity_2x4_mesh``: its
batch, its ``PHASE_ITERS``, on ``make_mesh_2d(2, 4)``).

The tiny configs have 2 attention heads: at model 4 the attention pairs
stay replicated (the JAX package cuts through a head there: a layout
difference only), at model 2 they split by heads.

Tolerances:
  * against JAX's 2 x 4 run (dropout 0 and JAX's window starts, as
    ``test_torch_parallel.py``'s mesh comparison): JAX's own, metrics rtol
    5e-4 / atol 1e-5, parameters rtol 3e-3 / atol 3e-4, codebook rtol 2e-4
    / atol 1e-5;
  * against one port rank on the same state and windows: metrics rtol 2e-5
    / atol 1e-6, codebook 2e-5, parameters atol ``2 * lr * steps`` with at
    most 0.2 % of the entries further than 1e-5 apart (the reduction order
    of a split product differs; Adam turns rounding-level gradients into
    steps of about lr), as ``test_torch_parallel.py`` holds 2 ranks to JAX.
"""

import jax
import numpy as np
import pytest
import torch

from msmctts_tpu.config import Config, component_kwargs
from msmctts_tpu.parallel.mesh import shard_batch
from msmctts_tpu.parallel.sharding import make_mesh_2d, shard_state, state_shardings
from msmctts_tpu.registry import get_trainer
from msmctts_tpu.tasks import build_task
from msmctts_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.parallel import sharding
from msmctts_tpu_torch.parallel.launch import run_ranks
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint
from tests import torch_mesh_workers as mw
from tests import torch_parallel_workers as workers
from tests.test_parallel import PHASE_ITERS, _make_batch
from tests.test_torch_parallel import _flat, _no_dropout
from tests.tiny import tiny_ae_config

torch.set_num_threads(2)

LR = 2e-4
JAX_METRICS = dict(rtol=5e-4, atol=1e-5)
JAX_PARAMS = dict(rtol=3e-3, atol=3e-4)
CODEBOOK = dict(rtol=2e-4, atol=1e-5)
ONE_METRICS = dict(rtol=2e-5, atol=1e-6)
DP_METRICS = dict(rtol=2e-4, atol=1e-5)  # what test_torch_am_train / emb_train hold 2 ranks to


def _ranks(fn, world, *args, timeout_s=240.0):
    return run_ranks(fn, world, "gloo", ["cpu"] * world, *args, timeout_s=timeout_s, threads=1)


def _with_mesh(config: dict, data: int, model: int) -> dict:
    return dict(config, mesh={"data": data, "model": model})


def _jax_marks(state, jmesh):
    """JAX paths of the parameters ``state_shardings`` splits over model."""
    specs = state_shardings(state["params"], jmesh)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]:
        if "model" in str(s.spec):
            out["/params/" + "/".join(str(getattr(k, "key", k)) for k in path)] = s.spec
    return out


@pytest.fixture(scope="module")
def ae_runs(tmp_path_factory):
    """JAX's 2 x 4 run and the port's one rank, 2 x 4 and 2 x 2 runs, all
    from the JAX trainer's initial state with dropout 0 and JAX's windows."""
    d = str(tmp_path_factory.mktemp("tp_ae"))
    config = _no_dropout(tiny_ae_config(d))
    config["save_checkpoint_dir"] = d + "/ckpt"
    batch = _make_batch()
    jmesh = make_mesh_2d(2, 4)
    with jax.default_matmul_precision("highest"):
        jtask = build_task(config, mode="train")
        jtrainer = get_trainer("VQGANTrainer")(config, jtask, mesh=jmesh, **component_kwargs(config.trainer))
        state0 = jax.device_get(jtrainer.init_state(jax.random.PRNGKey(0), batch))
        marks = _jax_marks(state0, jmesh)
        state, sharded = shard_state(state0, jmesh), shard_batch(batch, jmesh)
        j_metrics, starts = [], {}
        for it in PHASE_ITERS:
            state, m = jtrainer.train_step(state, sharded, it)
            j_metrics.append(m.to_host())
            if it > jtrainer.warmup_steps:
                r_win, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(jtrainer.seed), np.uint32(it)))
                maxval = np.maximum(batch["mel_length"].astype(np.int32) - jtrainer.frame_lengths, 1)
                starts[it] = np.asarray(jax.random.randint(r_win, (8,), 0, maxval))
        final = jax.device_get(state)
    cfg = config.to_dict()
    trainer = workers.build_trainer(cfg, {})
    W.train_state_from_jax(state0, trainer.ae, trainer.disc)
    state_t = {"autoencoder": W.state_dict_numpy(trainer.ae), "discriminator": W.state_dict_numpy(trainer.disc)}
    one = workers.run_steps(trainer, batch, PHASE_ITERS, starts)
    tp24 = _ranks(mw.tp_ae_rank, 8, _with_mesh(cfg, 2, 4), state_t, batch, PHASE_ITERS, starts)
    tp22 = _ranks(mw.tp_ae_rank, 4, _with_mesh(cfg, 2, 2), state_t, batch, PHASE_ITERS, starts)
    return dict(config=cfg, batch=batch, starts=starts, state0=state0, state_t=state_t, marks=marks,
                j_metrics=j_metrics, final=final, one=one, tp24=tp24, tp22=tp22, dir=d)


def _to_jax(state):
    trainer = workers.build_trainer(tiny_ae_config("/tmp").to_dict(), {})
    W.load_numpy_state(trainer.ae, state["autoencoder"])
    W.load_numpy_state(trainer.disc, state["discriminator"])
    return W.train_state_to_jax(trainer.ae, trainer.disc)


@pytest.mark.parametrize("shape", ["tp24", "tp22"])
def test_tp_metrics_match_jax_tp_and_one_rank(ae_runs, shape):
    ranks = ae_runs[shape]
    for it, (want, one, got) in enumerate(zip(ae_runs["j_metrics"], ae_runs["one"]["metrics"], ranks[0]["metrics"]), 1):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **JAX_METRICS, err_msg=f"step {it} {k}")
            np.testing.assert_allclose(got[k], one[k], **ONE_METRICS, err_msg=f"step {it} {k}")
    for r in ranks:  # the global values on every rank, one generator state for the run
        assert r["metrics"] == ranks[0]["metrics"]
        np.testing.assert_array_equal(r["rng"], ae_runs["one"]["rng"])


@pytest.mark.parametrize("shape", ["tp24", "tp22"])
def test_tp_state_matches_jax_tp_and_one_rank(ae_runs, shape):
    ranks = ae_runs[shape]
    assert all(r["deviation"] == 0.0 for r in ranks)  # gathered: bit-equal on every rank
    got = _to_jax(ranks[0]["state"])
    final = ae_runs["final"]
    for stage, node in final["codebook"]["quantizer"].items():
        for key in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(got["codebook"]["quantizer"][stage][key], node[key], **CODEBOOK,
                                       err_msg=f"{stage}.{key}")
    a, b = _flat(got["params"]["autoencoder"]), _flat(final["params"]["autoencoder"])
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], **JAX_PARAMS, err_msg=k)
    one = ae_runs["one"]["state"]
    for module, steps in (("autoencoder", 4), ("discriminator", 2)):
        far = total = 0
        for k, v in one[module].items():
            np.testing.assert_allclose(ranks[0]["state"][module][k], v, rtol=0, atol=2 * LR * steps + 1e-6, err_msg=k)
            far += int((np.abs(ranks[0]["state"][module][k] - v) > 1e-5).sum())
            total += v.size
        assert far <= 0.002 * total, (module, far, total)


def test_split_leaves_are_what_jax_marks(ae_runs):
    """The rules on the JAX paths: the port marks the leaves JAX's
    ``state_shardings`` marks at 2 x 4, and splits all of them but the
    attention pairs of 2 heads over 4 ranks."""
    facts = ae_runs["tp24"][0]["facts"]
    assert set(facts["marked"]) == set(ae_runs["marks"])
    assert facts["replicated"] and all("heads" in why for why in facts["replicated"].values())
    assert all(p.split("/")[-2] in ("qkv", "out") for p in facts["replicated"])
    assert len(facts["split"]) == len(facts["marked"]) - len(facts["replicated"])
    # at 2 x 2 the heads split as well: every marked leaf is split
    facts22 = ae_runs["tp22"][0]["facts"]
    assert not facts22["replicated"] and len(facts22["split"]) == len(facts22["marked"])
    assert any(n.endswith("slf_attn.linear.weight") for n in facts22["split"])
    # ECAPA's ConvReluBn named "out" is not an attention output
    assert not any(sharding.jax_rule(p, (4, 8, 8), 2) for p in ["/params/x/out/conv/kernel", "/params/x/out/bn/scale"])
    assert sharding.jax_rule("/params/x/slf_attn/out/kernel", (8, 8), 2) == -2


@pytest.mark.parametrize("shape", ["tp24", "tp22"])
def test_tp_collectives_run_on_their_groups(ae_runs, shape):
    """Rows over data, pairs over model, nothing over the world. A step's
    forward reduces one all-reduce per paired block it runs (the FFT
    blocks; in the GAN phase the MRF pairs too); the model group also
    carries each pair's backward sum, the row-parallel weight norms' sums
    (forward, backward, and g's gradient), the clip's norm, one broadcast
    of the replicated gradients per optimizer and one of the metrics; the
    data group what the 2-rank run of ``test_torch_parallel.py`` reduces."""
    r = ae_runs[shape][0]
    blocks = r["facts"]["blocks"]
    fft, mrf = blocks.get("MultiHeadAttention", 0) + blocks["ConvFFN"], blocks["ResBlock1"]
    for it, step in enumerate(r["collectives"], 1):
        gan = it > 2
        pairs = fft + (mrf if gan else 0)
        assert step["pair_reduces"] == pairs, (it, step)
        assert step["model all_reduce"]["calls"] == 2 * pairs + (3 * mrf if gan else 0) + 1, (it, step)
        assert step["data all_reduce"]["calls"] == (9 if gan else 8), (it, step)
        # from model rank 0: the replicated gradients, one broadcast per optimizer that steps, and the metrics
        assert step["model broadcast"]["calls"] == (2 if gan else 1) + 1, (it, step)
        assert not any(k.startswith("world") for k in step if k != "pair_reduces"), step


def test_tp_checkpoint_resume_and_loads(ae_runs, tmp_path):
    """At 2 x 2: a checkpoint after step 2 is the gathered state in the JAX
    layout (one rank loads it bit-equal, the JAX package loads it); a
    trainer resumed from it runs steps 3-4 as the run that went on."""
    cfg = _with_mesh(ae_runs["config"], 2, 2)
    res = _ranks(mw.tp_resume_rank, 4, cfg, ae_runs["state_t"], ae_runs["batch"], ae_runs["starts"], str(tmp_path))[0]
    cont, resumed = res["continued"], res["resumed"]
    assert resumed["metrics"] == cont["metrics"][2:]
    for module in ("autoencoder", "discriminator"):
        for k, v in cont["state"][module].items():
            np.testing.assert_array_equal(resumed["state"][module][k], v, err_msg=k)
    ck = load_checkpoint(res["path"])
    assert ck["iteration"] == 2 and "torch_opt_state" in ck["state"]
    one = workers.build_trainer(ae_runs["config"], {})
    one.load(res["path"])
    for module, got in (("autoencoder", one.ae), ("discriminator", one.disc)):
        for k, v in W.state_dict_numpy(got).items():
            np.testing.assert_array_equal(v, res["saved_state"][0 if module == "autoencoder" else 1][k], err_msg=k)
    jck = j_load_checkpoint(res["path"])
    rng = np.random.default_rng(3)
    with jax.default_matmul_precision("highest"):
        jtask = build_task(Config(jck["config"]), mode="infer")
        jtask.load_variables(jck["state"])
        wav = jtask.analysis_synthesis({"mel": rng.normal(size=(2, 16, 8)).astype(np.float32),
                                        "mel_length": np.array([16, 9], np.int32)})["wav"]
    assert all(np.isfinite(np.asarray(w)).all() and np.asarray(w).size for w in wav)


# ------------------------------------------------------------ the other trainers


@pytest.fixture(scope="module")
def am_runs(tmp_path_factory):
    """Two ``PredictorTrainer`` steps at global batch 4 with the recipe's
    dropout on, over the tiny pair's autoencoder as the teacher: one rank,
    and 2 x 2 (the heads split: the attention dropout is drawn for every
    head and sliced)."""
    from msmctts_tpu.data.loader import DataLoader as JDataLoader
    from msmctts_tpu.training.base_trainer import build_dataset_from_config as j_build_dataset
    from tests.test_torch_am_train import KEYS, _am_config
    from tests.tiny import write_tiny_dataset

    d = str(tmp_path_factory.mktemp("tp_am"))
    write_tiny_dataset(d, n_utts=8)
    pair = _tiny_pair(tmp_path_factory)
    config = _am_config(d, pair["ae"], d + "/ckpt", dropout=True)
    it = iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0))
    batches = [{k: b[k] for k in KEYS} for b in (next(it) for _ in range(2))]
    trainer = workers.build_trainer(config.to_dict(), {})
    trainer.init_state()
    state = {"predictor": W.state_dict_numpy(trainer.predictor)}
    one = workers.run_am_steps(trainer, batches)
    tp = _ranks(mw.tp_am_rank, 4, _with_mesh(config.to_dict(), 2, 2), state, batches)
    return one, tp


def _tiny_pair(tmp_path_factory):
    from tests.test_torch_slice import tiny_pair

    return tiny_pair.__wrapped__(tmp_path_factory)


def test_tp_predictor_steps_match_one_rank_with_the_clip_norm(am_runs):
    one, tp = am_runs
    for it, (want, got) in enumerate(zip(one["metrics"], tp[0]["metrics"]), 1):
        assert sorted(got) == sorted(want) and "grad_norm" in want
        for k in want:  # grad_norm: the clip's global norm, one rank's
            np.testing.assert_allclose(got[k], want[k], **DP_METRICS, err_msg=f"step {it} {k}")
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
    assert all(r["deviation"] == 0.0 for r in tp)
    assert any(n.endswith("slf_attn.linear.weight") for n in tp[0]["facts"]["split"])
    from tests.test_torch_am_train import _key_bias
    from tests.tiny import tiny_am_config

    cfg = tiny_am_config("/unused", "/unused").task["predictor"]["encoder_config"]
    for k, v in one["state"].items():  # the attention key bias: Adam noise (ROADMAP C), as the 2-rank test holds it
        keys = np.zeros(v.shape, bool)
        keys[_key_bias(k, cfg)] = True
        np.testing.assert_allclose(tp[0]["state"][k][~keys], v[~keys], rtol=2e-3, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(tp[0]["state"][k][keys], v[keys], rtol=0, atol=2 * LR * 2 + 1e-6, err_msg=k)


@pytest.fixture(scope="module")
def emb_runs(tmp_path_factory):
    """One ``EmbVQGANTrainer`` step (the supervised phase) at global batch 4
    from a seeded state: one rank and 2 x 2."""
    from msmctts_tpu.data.loader import DataLoader as JDataLoader
    from msmctts_tpu.training.base_trainer import build_dataset_from_config as j_build_dataset
    from tests.test_torch_emb_train import EMB_KEYS, _emb_config
    from tests.tiny import write_tiny_emb_dataset

    d = str(tmp_path_factory.mktemp("tp_emb"))
    write_tiny_emb_dataset(d)
    config = _emb_config(d, d + "/ckpt", dropout=True)
    batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0)))
    batch = {k: batch[k] for k in EMB_KEYS}
    trainer = workers.build_trainer(config.to_dict(), {})
    trainer.init_state()
    state = {name: W.state_dict_numpy(m) for name, m in trainer.task.networks.items()}
    one = workers.run_emb_steps(trainer, batch, 1)
    tp = _ranks(mw.tp_emb_rank, 4, _with_mesh(config.to_dict(), 2, 2), state, batch, 1)
    return one, tp


def test_tp_emb_step_matches_one_rank(emb_runs):
    one, tp = emb_runs
    for k, v in one["metrics"][0].items():
        np.testing.assert_allclose(tp[0]["metrics"][0][k], v, **DP_METRICS, err_msg=k)
    assert all(r["deviation"] == 0.0 for r in tp) and tp[0]["facts"]["split"]
    for name, sd in one["state"].items():
        for k, v in sd.items():
            np.testing.assert_allclose(tp[0]["state"][name][k], v, rtol=2e-3, atol=2e-4, err_msg=f"{name}.{k}")
