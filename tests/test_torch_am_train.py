"""The port's acoustic-model training slice against msmctts_tpu, on the CPU.

The teacher is a tiny autoencoder that the JAX package trains for 2 warmup
+ 2 GAN steps (as ``tests/test_trainers.py`` does), read-only. Checked, part
by part and then as a whole:
  * the two repairs of ``models/transformer.py``: the duration predictor's
    dropout (drawn in ``train()`` mode only) and the raw predicted
    durations that the length regulator returns in training;
  * the predictor's teacher-forced training forward;
  * the triplet loss and every embedding loss, values and gradients;
  * ``TTSDataset`` (durations in frames, and in seconds with the rounding
    error carried);
  * the slice: 3 steps of ``PredictorTrainer`` in both stacks from one JAX
    ``init_state`` carried across, dropout 0, the same batches;
  * the port's checkpoint: resumed by the port, loaded by both inference
    tasks; 2 ranks over gloo against 1 with dropout on; the CLI.

Tolerances (fp32, JAX under matmul precision "highest").
  * teacher indices, durations, lengths: equal.
  * modules and losses: 1e-5 (observed: up to 1.9e-6).
  * metrics of the slice: 2e-5 relative, 1e-6 absolute. The triplet losses
    of an untrained predictor are sums of ``margin / d`` hinges at the
    target codeword, whose self-mask is an exact float test (``raw != 0``)
    that rounding decides differently in the two stacks: ~1e-7 in all,
    inside the absolute term (observed: every other metric within 3.2e-7
    relative).
  * gradients of the first step: 1e-4 of the tensor's largest entry plus
    1e-7; parameters after the last step: ``2 * lr * steps``, with at most
    0.2 % of the entries further than 1e-5 apart (``test_torch_train_slice.py``
    says why), the attention's key bias aside: its gradient is 0 but for
    rounding (observed: 40 of its 48 entries further than 1e-5 apart, none
    of the other 17 481).
  * 2 ranks against 1, dropout on: the tolerances of ``test_torch_parallel.py``
    (metrics rtol 2e-4 / atol 1e-5, parameters rtol 2e-3 / atol 2e-4, the
    key bias ``2 * lr * steps``); the generator's state equal, the ranks'
    states bit-equal.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from msmctts_tpu.config import Config, component_kwargs
from msmctts_tpu.data.loader import DataLoader as JDataLoader
from msmctts_tpu.models.predictor import MultiStagePredictor
from msmctts_tpu.models.quantizer import EMAQuantizer as JEMAQuantizer
from msmctts_tpu.models.transformer import LengthRegulator
from msmctts_tpu.parallel.mesh import make_mesh
from msmctts_tpu.registry import get_trainer
from msmctts_tpu.tasks import build_task, load_frozen_autoencoder as j_load_frozen_autoencoder
from msmctts_tpu.training.base_trainer import build_dataset_from_config as j_build_dataset
from msmctts_tpu.utils.checkpoint import find_latest_checkpoint as j_find_latest
from msmctts_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.config import component_kwargs as t_component_kwargs
from msmctts_tpu_torch.data.loader import DataLoader as TDataLoader
from msmctts_tpu_torch.data.loader import to_device
from msmctts_tpu_torch.models import predictor as t_predictor
from msmctts_tpu_torch.models import quantizer as t_quantizer
from msmctts_tpu_torch.models import transformer as t_transformer
from msmctts_tpu_torch.ops.dropout import bind_generator
from msmctts_tpu_torch.parallel.launch import run_ranks
from msmctts_tpu_torch.registry import get_trainer as t_get_trainer
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.tasks import load_frozen_autoencoder as t_load_frozen_autoencoder
from msmctts_tpu_torch.training.base_trainer import build_dataset_from_config as t_build_dataset
from msmctts_tpu_torch.utils.checkpoint import find_latest_checkpoint, load_checkpoint
from tests import torch_parallel_workers as workers
from tests.tiny import FRAMESHIFT, tiny_ae_config, tiny_am_config, write_tiny_dataset

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 2e-4
STEPS = 3
METRIC_RTOL = 2e-5
GRAD_RTOL = 1e-4
TOL = 1e-5
KEYS = ("mel", "mel_length", "text", "text_length", "dur")
METHODS = ["mse", "softmax", "triple", "triple_mean", "triple_sum"]


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)  # a copy: JAX's arrays are read-only


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _no_dropout(config):
    p = config["task"]["predictor"]
    for node in (p["encoder_config"], p["decoder_config"]):
        node["dropout"] = 0.0
        node["attn_dropout"] = 0.0
    p["adaptor_config"]["dropout"] = 0.0
    return config


def _port_trainer(config_dict):
    cfg = TConfig(config_dict)
    task = t_build_task(cfg, device="cpu", mode="train")
    return t_get_trainer(cfg.trainer["_name"])(cfg, task, **t_component_kwargs(cfg.trainer))


def _recording(tx, log):
    """``tx`` that also hands every gradient tree it is given to ``log``."""

    def update(grads, state, params=None):
        jax.debug.callback(lambda g: log.append(jax.tree_util.tree_map(np.asarray, g)), grads)
        return tx.update(grads, state, params)

    return optax.GradientTransformation(tx.init, update)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_am_corpus"))
    write_tiny_dataset(d, n_utts=8)
    return d


@pytest.fixture(scope="module")
def trained_ae(corpus):
    """The tiny autoencoder after 2 warmup + 2 GAN steps of the JAX trainer."""
    config = tiny_ae_config(corpus)
    task = build_task(config, mode="train")
    trainer = get_trainer("VQGANTrainer")(config, task, **component_kwargs(config.trainer))
    trainer.train(max_steps=4, log_every=4)
    return j_find_latest(config.save_checkpoint_dir)


def _am_config(corpus, trained_ae, save_dir, dropout=False):
    config = tiny_am_config(corpus, trained_ae)
    if not dropout:
        config = _no_dropout(config)
    config["save_checkpoint_dir"] = save_dir
    return config


# --------------------------------------------------------------- the repairs


def _regulator_case(rng, dropout=0.0):
    B, Lt, D = 3, 7, 16
    x = rng.normal(size=(B, Lt, D)).astype(np.float32)
    lengths = np.array([7, 4, 6])
    non_pad = (np.arange(Lt)[None] < lengths[:, None]).astype(np.float32)[..., None]
    target = rng.integers(1, 5, size=(B, Lt)).astype(np.float32) * non_pad[..., 0]
    mod = LengthRegulator(input_size=D, duration_predictor_filter_size=8, dropout=dropout)
    with jax.default_matmul_precision("highest"):
        params = _np_tree(mod.init(jax.random.PRNGKey(1), x, non_pad, max_out_len=32)["params"])
    port = t_transformer.LengthRegulator(D, 8, dropout=dropout)
    W.load_numpy_state(port, W.duration_predictor_from_jax(params["DurationPredictor_0"], "duration_predictor"))
    return mod, params, port, x, non_pad, target


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_length_regulator_durations_match_jax(rng, mode):
    """Teacher-forced: the raw predictions, with their graph, in training
    (``deterministic=False``); the rounded targets at inference."""
    mod, params, port, x, non_pad, target = _regulator_case(rng)
    with jax.default_matmul_precision("highest"):
        want = mod.apply({"params": params}, x, non_pad, max_out_len=32, target=target,
                         deterministic=mode == "eval", rngs={"dropout": jax.random.PRNGKey(2)})
    port.train(mode == "train")
    xt = _t(x).requires_grad_(True)
    got = port(xt, _t(non_pad), 32, target=_t(target))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))  # lengths: by the targets
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), rtol=0, atol=TOL)
    if mode == "train":
        assert got[3].dtype == torch.float32 and got[3].requires_grad
        np.testing.assert_allclose(got[3].detach().numpy(), np.asarray(want[3]), rtol=TOL, atol=TOL)
        assert not np.array_equal(np.asarray(want[3]), np.round(np.asarray(want[3])))  # not rounded
        got[3].sum().backward()
        assert float(xt.grad.abs().sum()) > 0  # the duration loss reaches the encoder
    else:
        assert got[3].dtype == torch.int32
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_duration_predictor_draws_dropout_in_train_mode_only(rng):
    rate = 0.3
    dp = t_transformer.DurationPredictor(16, 64, dropout=rate)
    assert t_transformer.LengthRegulator(16, 64, dropout=rate).duration_predictor.dropout_2.rate == rate
    W.init_random(dp, 0)
    x = _t(rng.normal(size=(8, 40, 16)).astype(np.float32))
    non_pad = torch.ones(8, 40, 1)
    seen = {}
    for name in ("dropout_1", "dropout_2"):
        getattr(dp, name).register_forward_hook(lambda m, a, o, name=name: seen.__setitem__(name, o.detach()))

    def run(seed):
        bind_generator(dp, torch.Generator().manual_seed(seed))
        return dp.train()(x, non_pad).detach()

    first = run(5)
    for name, out in seen.items():  # LayerNorm outputs are never exactly 0: the zeros are the drops
        assert abs(float((out == 0).float().mean()) - rate) < 0.02, name
    assert torch.equal(run(5), first) and not torch.equal(run(6), first)  # the generator decides
    bind_generator(dp, None)
    dp.eval()
    state = torch.get_rng_state()
    plain = dp(x, non_pad)  # no generator needed: the identity
    assert torch.equal(torch.get_rng_state(), state)
    ref = t_transformer.DurationPredictor(16, 64, dropout=0.0).eval()
    ref.load_state_dict(dp.state_dict())
    assert torch.equal(plain, ref(x, non_pad)) and not torch.equal(plain, first)
    ref.train()  # rate 0 in training: the identity too, with no generator
    assert torch.equal(ref(x, non_pad), plain)


def test_predictor_training_forward_matches_jax(rng):
    kw = {k: v for k, v in _no_dropout(tiny_am_config("/unused", "/unused")).task["predictor"].items()
          if not k.startswith("_")}
    B, Lt, T = 3, 9, 32
    text_length = np.array([9, 5, 7])
    valid = np.arange(Lt)[None] < text_length[:, None]
    text = (rng.integers(1, 5, size=(B, Lt, 2)) * valid[..., None]).astype(np.int32)
    dur = (rng.integers(1, 4, size=(B, Lt)) * valid).astype(np.float32)
    total = dur.sum(1).astype(np.int32)
    feat_length = [((total + 1) // 2).astype(np.int32), total]
    feat = [rng.normal(size=(B, T // 2, 16)).astype(np.float32), rng.normal(size=(B, T, 16)).astype(np.float32)]
    mod = MultiStagePredictor(**kw)
    rngs = {"params": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(5)}
    with jax.default_matmul_precision("highest"):
        params = _np_tree(mod.init(rngs, text, text_length, dur=dur, feat=feat, feat_length=feat_length,
                                   deterministic=False)["params"])
        want = mod.apply({"params": params}, text, text_length, dur=dur, feat=feat, feat_length=feat_length,
                         deterministic=False, rngs={"dropout": jax.random.PRNGKey(6)})
    port = t_predictor.MultiStagePredictor(**kw).train()
    W.load_numpy_state(port, W.multi_stage_predictor_from_jax(params))
    got = port(_t(text, torch.long), _t(text_length, torch.long), dur=_t(dur),
               feat=[_t(f) for f in feat], feat_length=[_t(n, torch.long) for n in feat_length])
    assert got["duration"].requires_grad
    np.testing.assert_allclose(got["duration"].detach().numpy(), np.asarray(want["duration"]), rtol=TOL, atol=TOL)
    for g, w in zip(got["feat_length"], want["feat_length"]):  # the teacher's, as given
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert [tuple(f.shape) for f in got["feat"]] == [(B, T // 2, 16), (B, T, 16)]  # max_frames from the teacher
    for g, w in zip(got["feat"], want["feat"]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    # stage 1 reads the teacher's stage 0, not the prediction
    moved = port(_t(text, torch.long), _t(text_length, torch.long), dur=_t(dur),
                 feat=[_t(feat[0]) + 1.0, _t(feat[1])], feat_length=[_t(n, torch.long) for n in feat_length])
    assert torch.equal(moved["feat"][0], got["feat"][0]) and not torch.allclose(moved["feat"][1], got["feat"][1])


# ----------------------------------------------------------------- the losses


@pytest.mark.parametrize("reduction,H", [("mean", 2), ("sum", 2), ("sum", 1)], ids=["mean", "sum", "sum-one-head"])
def test_triple_loss_matches_jax(rng, reduction, H):
    d, K, B, T = 8, 16, 3, 10
    embed = rng.normal(size=(H, d, K)).astype(np.float32)
    pred = rng.normal(size=(B, T, H * d)).astype(np.float32)
    idx = rng.integers(0, K, size=(B, T, H)).astype(np.int32)
    pred[0, :4] = embed[np.arange(H), :, idx[0, :4]].reshape(4, H * d)  # on the target codeword
    if H == 1:
        idx = idx[..., 0]  # [B, T] indices of one head
    w = rng.uniform(0.5, 1.5, size=(B, T)).astype(np.float32)
    jq = JEMAQuantizer(H * d, K, n_head=H)
    variables = {"codebook": {"embed": embed, "cluster_size": np.zeros((H, K), np.float32), "embed_avg": embed}}
    f = lambda p: jq.apply(variables, p, idx, reduction, method="compute_triple_loss")
    with jax.default_matmul_precision("highest"):
        want = f(pred)
        want_grad = jax.grad(lambda p: jnp.sum(f(p) * w))(pred)
    tq = t_quantizer.EMAQuantizer(H * d, K, n_head=H)
    with torch.no_grad():
        tq.embed.copy_(_t(embed))
    p = _t(pred).requires_grad_(True)
    got = tq.compute_triple_loss(p, _t(idx, torch.long), reduction)
    (got * _t(w)).sum().backward()
    assert got.shape == (B, T)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=TOL, atol=TOL)
    assert float(np.abs(want).max()) > 0.1  # real hinges, not only the margin


def test_codebook_distances_match_jax(rng):
    from msmctts_tpu.models.quantizer import nearest_codes

    x = rng.normal(size=(4, 5, 2, 8)).astype(np.float32)
    embed = rng.normal(size=(2, 8, 16)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        _, want = nearest_codes(x, embed)
    got = t_quantizer.codebook_distances(_t(x), _t(embed))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # the snap is the argmin of these distances
    idx, _ = t_quantizer.nearest_codes(_t(x), _t(embed))
    np.testing.assert_array_equal(idx.numpy(), got.argmin(-1).numpy())


@pytest.fixture(scope="module")
def teacher(corpus, trained_ae):
    """The trained autoencoder in both stacks and its analysis of a batch."""
    config = tiny_am_config(corpus, trained_ae)
    batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0)))
    jae, jvars, _ = j_load_frozen_autoencoder(trained_ae)
    with jax.default_matmul_precision("highest"):
        jq = jae.apply(jvars, batch["mel"], batch["mel_length"], method="analysis")
    tae, _ = t_load_frozen_autoencoder(trained_ae, device="cpu")
    with torch.no_grad():
        tq = tae.analysis(_t(batch["mel"]), _t(batch["mel_length"], torch.long))
    return dict(jae=jae, jvars=jvars, jq=jq, tae=tae, tq=tq, batch=batch)


def test_teacher_analysis_matches_jax(teacher):
    jq, tq = teacher["jq"], teacher["tq"]
    assert not teacher["tae"].training
    for g, w in zip(tq["quantizer_indices"], jq["quantizer_indices"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(tq["quantizer_lengths"], jq["quantizer_lengths"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(tq["quantizer_outputs"], jq["quantizer_outputs"]):  # straight-through values
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("weights", [[[1.0, 0.5, 2.0, 0.3, 1.5], [0.7, 1.0, 0.2, 1.1, 0.9]], [1.0, 0.5, 2.0, 0.3, 1.5]],
                         ids=["per-stage-weights", "flat-weights"])
def test_embedding_losses_match_jax(rng, teacher, weights):
    jq = teacher["jq"]
    preds = [rng.normal(size=np.shape(o)).astype(np.float32) for o in jq["quantizer_outputs"]]
    lengths = [np.asarray(n) for n in jq["quantizer_lengths"]]
    f = lambda ps: teacher["jae"].apply(teacher["jvars"], ps, lengths, jq, methods=METHODS, loss_weights=weights,
                                        method="compute_embedding_loss")
    with jax.default_matmul_precision("highest"):
        want = jax.device_get(f(preds))
        want_grads = jax.grad(lambda ps: f(ps)["total_loss"])(preds)
    states = {"quantizer_outputs": [_t(o) for o in jq["quantizer_outputs"]],
              "quantizer_indices": [_t(i, torch.long) for i in jq["quantizer_indices"]]}
    ps = [_t(p).requires_grad_(True) for p in preds]
    got = teacher["tae"].compute_embedding_loss(ps, [_t(n, torch.long) for n in lengths], states, METHODS, weights)
    got["total_loss"].backward()
    assert sorted(got) == sorted(want) and len(got) == 1 + 2 * len(METHODS)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=TOL, atol=TOL, err_msg=k)
    for p, g in zip(ps, want_grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="unknown embedding loss"):
        teacher["tae"].compute_embedding_loss(ps, [_t(n, torch.long) for n in lengths], states, ["l1"], [1.0])


# ---------------------------------------------------------------- the dataset


@pytest.fixture(scope="module")
def seconds_corpus(tmp_path_factory):
    """The tiny corpus with its duration book in seconds, off the frame
    grid by up to 0.45 frames, so that rounding carries errors along."""
    d = str(tmp_path_factory.mktemp("torch_am_seconds"))
    write_tiny_dataset(d, n_utts=8, seed=3)
    rng = np.random.default_rng(4)
    lines = []
    for line in open(f"{d}/dur.txt").read().split("\n"):
        if not line:
            continue
        uid, frames = line.split("|")
        frames = np.array([float(v) for v in frames.split()])
        seconds = (frames + rng.uniform(-0.45, 0.45, size=frames.shape)) * FRAMESHIFT / 1600
        lines.append(uid + "|" + " ".join(repr(float(s)) for s in seconds))
    with open(f"{d}/dur.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
    return d


@pytest.mark.parametrize("unit", ["frames", "seconds"])
def test_tts_dataset_matches_jax(corpus, seconds_corpus, unit):
    d = corpus if unit == "frames" else seconds_corpus
    config = tiny_am_config(d, "/unused")
    jd = j_build_dataset(config, training=False)
    td = t_build_dataset(TConfig(config.to_dict()), training=False)
    assert len(td) == len(jd) == 8
    carried = 0
    for i in range(len(jd)):
        a, b = jd.parse_case(i), td.parse_case(i)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=f"{i} {k}")
        assert b["dur"].dtype == np.float32 and b["dur"].sum() == b["mel"].shape[0]
        assert np.array_equal(b["dur"], np.round(b["dur"]))
        if unit == "seconds":  # each rounded with the error before it carried: not the lone rounding
            raw = np.asarray(td.dataset[(td.id_list[i], "dur")], np.float64) * 1600 / FRAMESHIFT
            carried += int(not np.array_equal(b["dur"][:-1], np.round(raw)[:-1]))
    assert carried > 0 or unit == "frames"
    # batches through both loaders, in the same order
    jl = iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0, seed=1234))
    tl = iter(TDataLoader(t_build_dataset(TConfig(config.to_dict()), training=True), batch_size=4, num_workers=2, seed=1234))
    for _ in range(3):
        a, b = next(jl), next(tl)
        assert sorted(a) == sorted(b) == sorted(KEYS)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tl.close()
    assert b["text"].shape[1] == 16 and b["mel"].shape[1] == 64  # the text and frame buckets


def test_tts_dataset_refuses_durations_that_miss_the_frames(corpus, tmp_path):
    config = tiny_am_config(corpus, "/unused")
    book = tmp_path / "dur.txt"
    lines = open(f"{corpus}/dur.txt").read().split("\n")
    uid, frames = lines[0].split("|")
    lines[0] = uid + "|" + " ".join(str(int(v) + 2) for v in frames.split())  # 8+ frames too many
    book.write_text("\n".join(lines))
    config["dataset"]["feature_path"][1] = str(book)
    td = t_build_dataset(TConfig(config.to_dict()), training=False)
    with pytest.raises(ValueError, match="vs dur"):
        td.parse_case(td.id_list.index((uid,)))


# ------------------------------------------------------------------ the slice


@pytest.fixture(scope="module")
def am_parity(corpus, trained_ae):
    """Both stacks through 3 steps from one JAX init_state."""
    config = _am_config(corpus, trained_ae, corpus + "/ckpt_am_parity")
    with jax.default_matmul_precision("highest"):
        jtask = build_task(config, mode="train")
        jt = get_trainer("PredictorTrainer")(config, jtask, mesh=make_mesh(1), **component_kwargs(config.trainer))
        it = iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0, seed=1234))
        batches = [{k: b[k] for k in KEYS} for b in (next(it) for _ in range(STEPS))]
        state = jt.init_state(jax.random.PRNGKey(0), batches[0])
        state0 = jax.device_get(state)  # the step donates its input state
        log = []
        jt.tx = _recording(jt.tx, log)  # read when the step is first traced
        j_states, j_metrics, j_indices = {0: state0}, {}, []
        for i, b in enumerate(batches, 1):
            state, m = jt.train_step(state, b, i)
            j_states[i] = jax.device_get(state)
            j_metrics[i] = m.to_host()
            jax.effects_barrier()
            q = jt.ae.apply(jt.ae_variables, b["mel"], b["mel_length"], method="analysis")
            j_indices += [np.asarray(x) for x in q["quantizer_indices"]]
    assert len(log) == STEPS

    trainer = _port_trainer(config.to_dict())
    trainer.load_state_tree(state0)
    t_indices, t_metrics, t_grads = [], {}, {}
    hooks = [q.register_forward_hook(lambda m, a, o: t_indices.append(o[2].numpy().copy()))
             for q in trainer.frozen_autoencoder().quantizer.quantizer]
    teacher0 = {k: v.clone() for k, v in trainer.ae.state_dict().items()}
    step = trainer.opt.step
    for i, b in enumerate(batches, 1):
        seen = {}
        trainer.opt.step = lambda: (seen.update({k: p.grad.numpy().copy() for k, p in trainer.predictor.named_parameters()}),
                                    step())[1]
        t_metrics[i] = {k: float(v) for k, v in trainer.train_step(to_device(b, "cpu"), i).items()}
        trainer.opt.step = step
        t_grads[i] = W.multi_stage_predictor_to_jax(seen)
    for h in hooks:
        h.remove()
    return dict(j_states=j_states, j_metrics=j_metrics, j_grads=log, j_indices=j_indices, batches=batches,
                trainer=trainer, t_metrics=t_metrics, t_grads=t_grads, t_indices=t_indices, teacher0=teacher0)


@pytest.mark.parametrize("it", range(1, STEPS + 1))
def test_am_step_metrics_match_jax(am_parity, it):
    got, want = am_parity["t_metrics"][it], am_parity["j_metrics"][it]
    assert sorted(got) == sorted(want)
    assert {"embed_loss_mse_0", "embed_loss_triple_sum_1", "duration_loss", "total_loss", "grad_norm"} <= set(got)
    for k in want:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL, abs=1e-6), (k, got[k], want[k])
    assert got["grad_norm"] > 10.0  # the clip at 10 took effect: the norm is read before it


def test_am_first_step_gradients_match_jax(am_parity):
    got, want = _flat(am_parity["t_grads"][1]), _flat(am_parity["j_grads"][0])
    assert sorted(got) == sorted(want)
    live = 0
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=GRAD_RTOL * scale + 1e-7, err_msg=k)
        live += scale > 0
    assert live == len(want)  # every parameter, the duration head's included, takes a gradient


def _key_bias(name, cfg):
    """The entries of an attention's fused qkv bias (JAX or port name) that
    shift the keys (per head: q [d_k], k [d_k], v [d_v]), else none."""
    if not name.endswith(("MultiHeadAttention_0/qkv/bias", "slf_attn.linear.bias")):
        return slice(0, 0)
    d_k, d_v = cfg["d_k"], cfg["d_v"]
    idx = np.arange(cfg["n_head"] * (2 * d_k + d_v)) % (2 * d_k + d_v)
    return (idx >= d_k) & (idx < 2 * d_k)


def test_am_parameters_match_jax_after_the_last_step(am_parity):
    """The key bias adds one constant to a query's scores over all keys, so
    softmax cancels it: its gradient is 0, and rounding noise in both
    stacks, which Adam's normalization turns into steps of about ``lr``
    in either direction. It is held to ``2 * lr * steps`` with the rest and
    left out of the count of entries further than 1e-5 apart."""
    trainer = am_parity["trainer"]
    cfg = trainer.config.task["predictor"]["encoder_config"]
    got = _flat(trainer.state_tree()["params"]["predictor"])
    want = _flat(am_parity["j_states"][STEPS]["params"]["predictor"])
    start = _flat(am_parity["j_states"][0]["params"]["predictor"])
    grads = _flat(am_parity["j_grads"][0])
    assert sorted(got) == sorted(want)
    far = total = moved = noise = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * LR * STEPS + 1e-6, err_msg=k)
        keys = np.zeros(want[k].shape, bool)
        keys[_key_bias(k, cfg)] = True
        assert float(np.abs(grads[k][keys]).max(initial=0.0)) <= 1e-6 * float(np.abs(grads[k]).max()), k
        noise += int(keys.sum())
        far += int(((np.abs(got[k] - want[k]) > 1e-5) & ~keys).sum())
        total += want[k].size
        moved += int((want[k] != start[k]).sum())
    assert noise == 3 * cfg["n_head"] * cfg["d_k"]  # the encoder's and both decoders' attention
    assert far <= 0.002 * total, (far, total)
    assert moved > 0.5 * total


def test_am_teacher_is_frozen_and_its_indices_match_jax(am_parity):
    trainer = am_parity["trainer"]
    assert len(am_parity["t_indices"]) == 2 * STEPS  # one snap per stage per step
    for got, want in zip(am_parity["t_indices"], am_parity["j_indices"]):
        np.testing.assert_array_equal(got, want)
    assert not trainer.ae.training and not any(p.requires_grad for p in trainer.ae.parameters())
    for k, v in trainer.ae.state_dict().items():  # parameters and codebooks untouched
        assert torch.equal(v, am_parity["teacher0"][k]), k
    # the durations the predictor was forced with: the dataset's, in both stacks
    td = t_build_dataset(trainer.config, training=True)
    loader = iter(TDataLoader(td, batch_size=4, num_workers=0, seed=1234))
    for b in am_parity["batches"]:
        np.testing.assert_array_equal(next(loader)["dur"], b["dur"])
        assert np.array_equal(b["dur"].sum(1), b["mel_length"])


# ------------------------------------------------------- checkpoint and ranks


def test_am_checkpoint_resumes_and_loads_into_both_inference_tasks(corpus, trained_ae, tmp_path):
    config = _am_config(corpus, trained_ae, str(tmp_path / "ckpt"), dropout=True)
    trainer = _port_trainer(config.to_dict())
    trainer.train(max_steps=2, log_every=1)
    path = find_latest_checkpoint(config["save_checkpoint_dir"])
    assert path.endswith("model_2") and trainer.opt.count == 2
    ckpt = load_checkpoint(path)
    assert sorted(ckpt["state"]) == ["params", "torch_opt_state", "torch_rng"]
    assert list(ckpt["state"]["params"]) == ["predictor"]
    # the port resumes it: weights, moments, schedule position and generator
    again = _port_trainer(config.to_dict())
    again.init_state()
    again.load(path)
    assert again.iteration == 2 and again.opt.count == 2
    for (k, a), b in zip(again.predictor.state_dict().items(), trainer.predictor.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(again.generator.get_state(), trainer.generator.get_state())
    moments = lambda t: [s["exp_avg"] for s in t.opt.opt.state.values()]
    assert all(torch.equal(a, b) for a, b in zip(moments(again), moments(trainer)))
    again.train(max_steps=1, log_every=1)
    assert again.iteration == 3 and again.opt.count == 3
    assert find_latest_checkpoint(config["save_checkpoint_dir"]).endswith("model_3")

    # both inference tasks load it; with the durations forced, the same codewords and waveform
    rng = np.random.default_rng(5)
    text_length = np.array([6, 4])
    valid = np.arange(8)[None] < text_length[:, None]
    text = (np.stack([rng.integers(1, 20, (2, 8)), rng.integers(0, 5, (2, 8))], -1) * valid[..., None]).astype(np.int32)
    batch = {"text": text, "text_length": text_length.astype(np.int32),
             "dur": (rng.integers(1, 5, (2, 8)) * valid).astype(np.float32)}
    task = t_build_task(TConfig(ckpt["config"]), device="cpu")
    task.load_variables(ckpt["state"])
    got = task.infer_step(batch)
    jck = j_load_checkpoint(path)
    with jax.default_matmul_precision("highest"):
        jtask = build_task(Config(jck["config"]), mode="infer")
        jtask.load_variables(jck["state"])
        want = jtask.infer_step(batch)
    np.testing.assert_array_equal(got["mel_length"], np.asarray(want["mel_length"]))
    for a, b in zip(got["embedding"], want["embedding"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(got["wav"], want["wav"]):
        assert a.shape == np.asarray(b).shape and np.isfinite(a).all()
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def am_dp_runs(corpus, trained_ae):
    """2 steps at global batch 4 with the recipe's dropout on, from one
    seeded state: one rank, and two ranks over gloo."""
    config = _am_config(corpus, trained_ae, corpus + "/ckpt_am_dp", dropout=True)
    it = iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0))
    batches = [{k: b[k] for k in KEYS} for b in (next(it) for _ in range(2))]
    trainer = workers.build_trainer(config.to_dict(), {})
    trainer.init_state()
    state = {"predictor": W.state_dict_numpy(trainer.predictor)}
    one = workers.run_am_steps(trainer, batches)
    two = run_ranks(workers.am_steps_rank, 2, "gloo", ["cpu"] * 2, config.to_dict(), state, batches,
                    timeout_s=240, threads=2)
    return one, two, state


def test_am_two_ranks_with_dropout_match_one_rank(am_dp_runs):
    one, two, state0 = am_dp_runs
    for it, (m1, m2) in enumerate(zip(one["metrics"], two[0]["metrics"]), 1):
        assert sorted(m1) == sorted(m2)
        for k in m1:
            np.testing.assert_allclose(m2[k], m1[k], rtol=2e-4, atol=1e-5, err_msg=f"step {it} {k}")
    assert two[0]["metrics"] == two[1]["metrics"]  # the global values, on every rank
    for i, want in enumerate(one["indices"]):  # the teacher snaps each rank's rows
        np.testing.assert_array_equal(np.concatenate([two[0]["indices"][i], two[1]["indices"][i]]), want)
    moved = 0
    cfg = tiny_am_config("/unused", "/unused").task["predictor"]["encoder_config"]
    for k, v in one["state"].items():
        keys = np.zeros(v.shape, bool)
        keys[_key_bias(k, cfg)] = True  # rounding-noise gradients: see the parameters' test above
        np.testing.assert_allclose(two[0]["state"][k][~keys], v[~keys], rtol=2e-3, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(two[0]["state"][k][keys], v[keys], rtol=0, atol=2 * LR * 2 + 1e-6, err_msg=k)
        moved += int(not np.array_equal(v, state0["predictor"][k]))
    assert moved > 0.5 * len(one["state"])
    # one generator state for the run: every rank drew the global batch's masks
    np.testing.assert_array_equal(two[0]["rng"], one["rng"])
    np.testing.assert_array_equal(two[1]["rng"], one["rng"])
    assert not np.array_equal(one["rng"], torch.Generator().manual_seed(1234).get_state().numpy())  # dropout drew


def test_am_ranks_stay_bit_equal_and_count_their_collectives(am_dp_runs):
    _, two, _ = am_dp_runs
    assert two[0]["deviation"] == 0.0 and two[1]["deviation"] == 0.0
    for k, v in two[0]["state"].items():
        np.testing.assert_array_equal(two[1]["state"][k], v, err_msg=k)
    # per step: 2 embedding-loss denominators + 1 duration denominator + the gradients + the metrics
    assert [c["all_reduce"]["calls"] for c in two[0]["collectives"]] == [5, 5]
    assert all(c["broadcast"]["calls"] == 0 and c["all_gather"]["calls"] == 0 for c in two[0]["collectives"])


def test_am_train_entry_point_on_cpu(corpus, trained_ae, tmp_path):
    config = _am_config(corpus, trained_ae, str(tmp_path / "ckpt_cli"), dropout=True)
    cfg_path = str(tmp_path / "am.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config.to_dict(), f)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-m", "msmctts_tpu_torch.train", "-c", cfg_path, "--device", "cpu", "--max-steps", "2",
         "--log-every", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "step 2" in res.stdout and "embed_loss_triple_sum_1=" in res.stdout and "duration_loss=" in res.stdout
    assert os.path.exists(os.path.join(config["save_checkpoint_dir"], "model_2"))
