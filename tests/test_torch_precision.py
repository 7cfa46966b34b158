"""bf16 mixed precision (``precision: bfloat16``) in the port against the
JAX package's, on the CPU at ``tests/tiny.py`` widths.

The JAX policy rounds the parameters (and in the trainers the float inputs)
to bf16 and lets type promotion decide every later op's dtype; fp32 arrays
(masks, the sinusoid position table, codebooks, losses) pull most of the
graph back to fp32. The port must compute what that policy computes, not a
faster one, so these tests hold it to JAX's bf16 run, not to its fp32 run:

  * ``compute_dtype`` on every name, and its ``ValueError``;
  * one warmup and one GAN ``VQGANTrainer`` step and one
    ``PredictorTrainer`` step, each carried from one JAX state: every
    metric of the port's bf16 run is nearer JAX's bf16 run than JAX's fp32
    run (where the two JAX runs differ at all), and within a stated
    tolerance of JAX's bf16 run; masters and codebooks stay fp32;
  * a dtype census: the forwards of the autoencoder and of the predictor
    under bf16 run the same number of convolutions and of matrix products
    per operand dtype in both stacks (JAX: ``conv_general_dilated`` and
    ``dot_general`` in ``jax.make_jaxpr``; the port: ``aten.convolution``
    and ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` under a
    ``TorchDispatchMode``; one ``F.linear`` or ``einsum`` is one product);
  * the inference task's ``analysis_synthesis`` and ``predict`` of the tiny
    AE + AM pair under bf16 against JAX's task: indices and durations
    equal, the wav within a stated tolerance;
  * ``NASynEmbFSTrainer`` under bf16 equals its fp32 run (the JAX trainer
    reads no precision); ``--int8`` under bf16 against JAX's bf16 int8 task.

Tolerances (JAX under matmul precision "highest", the port's TF32 off).
  * Step metrics vs JAX bf16: 2e-3 relative (observed: up to 3.3e-4; the
    stacks round the same values to bf16, and a product or sum whose inputs
    differ by one bf16 step moves its result by about 4e-3 of it, which
    averages out over the loss's terms).
  * EmbVQGANTrainer's supervised step vs JAX bf16: 2e-3 relative
    (observed: up to 4.3e-4, the frame loss). ECAPA runs its 32 convolutions
    in bf16 there, and XLA rounds a chain of bf16 ops otherwise than torch's
    op-by-op rounding (``jax.nn.softmax``'s two roundings, mirrored in
    ``models/tdnn.py``, were worth 5.9e-3 -> 4.3e-4).
  * Inference wav vs JAX bf16: 1e-4 absolute on the tiny pair, 5e-4 on the
    trained fixture, as the fp32 slice (``test_torch_slice.py``): the
    activations are fp32 there in both stacks, over bf16-rounded weights.
    The fixture's decode moves 0.027 relative L2 from fp32 to bf16 in JAX
    and stays within 2.6e-6 of JAX's bf16 decode in the port.
"""

import collections
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from msmctts_tpu.config import Config, component_kwargs
from msmctts_tpu.data.loader import DataLoader as JDataLoader
from msmctts_tpu.parallel.mesh import make_mesh
from msmctts_tpu.parallel.precision import cast_floats as j_cast_floats
from msmctts_tpu.registry import get_trainer
from msmctts_tpu.tasks import build_task
from msmctts_tpu.training.base_trainer import build_dataset_from_config as j_build_dataset
from msmctts_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.config import component_kwargs as t_component_kwargs
from msmctts_tpu_torch.data.loader import to_device
from msmctts_tpu_torch.ops.dropout import bind_generator
from msmctts_tpu_torch.parallel.precision import cast_floats, compute_dtype, functional
from msmctts_tpu_torch.registry import get_trainer as t_get_trainer
from msmctts_tpu_torch.serving import BatchingEngine
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint as t_load_checkpoint
from msmctts_tpu_torch.utils.checkpoint import save_checkpoint as t_save_checkpoint
from tests.test_torch_slice import _batch, tiny_pair  # noqa: F401  (a fixture)
from tests.tiny import MEL_DIM, tiny_ae_config, tiny_am_config, tiny_emb_config, write_tiny_dataset, \
    write_tiny_emb_dataset

torch.set_num_threads(2)

METRIC_RTOL = 2e-4
EMB_RTOL = 2e-3
METRIC_ATOL = 1e-6
WAV_TOL = 1e-4
FIXTURE_WAV_TOL = 5e-4  # as test_torch_slice.py::test_fixture_analysis_synthesis_matches_jax
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "csmsc_ae_r5.f16.ckpt")
PRODUCTS = {"mm", "addmm", "bmm", "baddbmm"}


def _no_dropout(config):
    ae = config["task"]["autoencoder"]
    for node in (ae["encoder_config"], ae["frame_decoder_config"]):
        node["dropout"] = 0.0
        node["attn_dropout"] = 0.0
    ae["quantizer_config"]["dropout"] = 0.0
    ae["quantizer_config"]["prior_config"]["p_dropout"] = 0.0
    return config


def _am_no_dropout(config):
    p = config["task"]["predictor"]
    for node in (p["encoder_config"], p["decoder_config"]):
        node["dropout"] = 0.0
        node["attn_dropout"] = 0.0
    p["adaptor_config"]["dropout"] = 0.0
    return config


def _precision(config, name):
    config = Config(copy.deepcopy(config.to_dict()))
    config["precision"] = name
    return config


def _port_trainer(config):
    cfg = TConfig(config.to_dict())
    task = t_build_task(cfg, device="cpu", mode="train")
    return t_get_trainer(cfg.trainer["_name"])(cfg, task, **t_component_kwargs(cfg.trainer))


def _jax_trainer(config):
    return get_trainer(config.trainer["_name"])(config, build_task(config, mode="train"), mesh=make_mesh(1),
                                                **component_kwargs(config.trainer))


def _fresh(state):
    return jax.tree_util.tree_map(jnp.asarray, state)


def _walk(jaxpr, counts):
    for e in jaxpr.eqns:
        if e.primitive.name in ("conv_general_dilated", "dot_general"):
            kind = "conv" if e.primitive.name == "conv_general_dilated" else "product"
            counts[(kind, tuple(str(v.aval.dtype) for v in e.invars))] += 1
        for p in e.params.values():
            for sub in p if isinstance(p, (list, tuple)) else [p]:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    _walk(inner, counts)


def jax_census(fn, *args):
    counts = collections.Counter()
    _walk(jax.make_jaxpr(fn)(*args).jaxpr, counts)
    return dict(counts)


class Census(TorchDispatchMode):
    """Convolutions and matrix products by operand dtypes."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name == "convolution" or name in PRODUCTS:
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            ts = ts[1:3] if name in ("addmm", "baddbmm") else ts[:2]  # the bias is not an operand
            kind = "conv" if name == "convolution" else "product"
            self.counts[(kind, tuple(str(t.dtype).replace("torch.", "") for t in ts))] += 1
        return func(*args, **(kwargs or {}))


# ------------------------------------------------------------------ policy


@pytest.mark.parametrize("name,dtype", [("bf16", torch.bfloat16), ("bfloat16", torch.bfloat16),
                                        ("BFloat16", torch.bfloat16), ("fp32", torch.float32),
                                        ("float32", torch.float32), (None, torch.float32)])
def test_compute_dtype_names(name, dtype):
    config = {} if name is None else {"precision": name}
    assert compute_dtype(config) == dtype


@pytest.mark.parametrize("name", ["fp16", "half", "float16", "int8"])
def test_compute_dtype_refuses_other_names(name):
    with pytest.raises(ValueError, match="unknown precision"):
        compute_dtype({"precision": name})


def test_cast_floats_leaves_integers_and_is_differentiable():
    x = torch.randn(3, requires_grad=True)
    tree = cast_floats({"x": x, "n": torch.arange(3), "l": [x, 2.0]}, torch.bfloat16)
    assert tree["x"].dtype == tree["l"][0].dtype == torch.bfloat16
    assert tree["n"].dtype == torch.long and tree["l"][1] == 2.0
    tree["x"].float().sum().backward()
    assert x.grad.dtype == torch.float32 and torch.equal(x.grad, torch.ones(3))
    assert cast_floats(x, torch.float32) is x


# -------------------------------------------------------------- train steps


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_precision_corpus"))
    write_tiny_dataset(d, n_utts=8)
    return d


@pytest.fixture(scope="module")
def vq_runs(corpus):
    """One warmup and one GAN step of the tiny recipe from one JAX state:
    JAX fp32, JAX bf16 and the port bf16 (the windows JAX drew)."""
    config = _no_dropout(tiny_ae_config(corpus))
    config["trainer"]["warmup_steps"] = 1
    config["save_checkpoint_dir"] = corpus + "/ckpt_vq"
    runs = {}
    with jax.default_matmul_precision("highest"):
        batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0)))
        batch = {k: batch[k] for k in ("mel", "mel_length", "wav")}
        for name in ("float32", "bfloat16"):
            jt = _jax_trainer(_precision(config, name))
            if name == "float32":
                state0 = jax.device_get(jt.init_state(jax.random.PRNGKey(0), batch))
            state = _fresh(state0)
            runs[name] = {}
            for it in (1, 2):
                state, m = jt.train_step(state, batch, it)
                runs[name][it] = m.to_host()
            if name == "float32":
                final32 = jax.device_get(state)
        r_win, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(jt.seed), np.uint32(2)))
        maxval = np.maximum(batch["mel_length"].astype(np.int32) - jt.frame_lengths, 1)
        starts = np.asarray(jax.random.randint(r_win, (4,), 0, maxval))

    trainer = _port_trainer(_precision(config, "bfloat16"))
    W.train_state_from_jax(state0, trainer.ae, trainer.disc)
    t_batch = to_device(batch, "cpu")
    port = {1: trainer.train_step(t_batch, 1), 2: trainer.train_step(t_batch, 2, starts=torch.tensor(starts))}
    port = {it: {k: float(v) for k, v in m.items()} for it, m in port.items()}
    teacher = os.path.join(corpus, "teacher.ckpt")
    save_checkpoint(teacher, {"params": {"autoencoder": final32["params"]["autoencoder"]},
                              "codebook": final32["codebook"]}, 2, config.to_dict())
    return dict(config=config, batch=batch, state0=state0, jax=runs, port=port, trainer=trainer, teacher=teacher)


def _nearer_bf16(port, j16, j32, what, rtol):
    """Every metric within ``rtol`` of JAX bf16; where the two JAX runs
    part by more than that, the port's is nearer bf16 than fp32. Returns
    how many parted."""
    assert sorted(port) == sorted(j16) == sorted(j32), what
    parted = 0
    for k in j16:
        got, a, b = port[k], j16[k], j32[k]
        assert np.isfinite(got), (what, k)
        assert got == pytest.approx(a, rel=rtol, abs=METRIC_ATOL), (what, k, got, a, b)
        if abs(a - b) > rtol * abs(a) + METRIC_ATOL:
            parted += 1
            assert abs(got - a) < abs(got - b), (what, k, got, a, b)
    return parted


@pytest.mark.parametrize("it", [1, 2], ids=["warmup", "gan"])
def test_vqgan_step_metrics_follow_jax_bf16(vq_runs, it):
    parted = _nearer_bf16(vq_runs["port"][it], vq_runs["jax"]["bfloat16"][it], vq_runs["jax"]["float32"][it],
                          f"step {it}", METRIC_RTOL)
    assert parted >= 1  # bf16 is a different run from fp32 here, and the port is the bf16 one


def test_vqgan_masters_and_codebooks_stay_fp32(vq_runs):
    trainer = vq_runs["trainer"]
    for module in (trainer.ae, trainer.disc):
        for name, p in module.named_parameters():
            assert p.dtype == torch.float32, name
        for name, b in module.named_buffers():
            assert b is None or not b.is_floating_point() or b.dtype == torch.float32, name
    for opt in (trainer.ae_opt, trainer.d_opt):
        for state in opt.state.values() if hasattr(opt, "state") else []:
            for v in state.values() if isinstance(state, dict) else []:
                assert not torch.is_tensor(v) or v.dtype == torch.float32
    # the steps moved the masters and the codebook
    start = W.train_state_to_jax(trainer.ae, trainer.disc)
    assert not np.allclose(start["codebook"]["quantizer"]["vq_0"]["embed"],
                           vq_runs["state0"]["codebook"]["quantizer"]["vq_0"]["embed"])


@pytest.fixture(scope="module")
def am_runs(corpus, vq_runs):
    """One PredictorTrainer step against the teacher of ``vq_runs`` from
    one JAX state: JAX fp32, JAX bf16 and the port bf16."""
    config = _am_no_dropout(tiny_am_config(corpus, vq_runs["teacher"]))
    config["save_checkpoint_dir"] = corpus + "/ckpt_am"
    keys = ("mel", "mel_length", "text", "text_length", "dur")
    runs = {}
    with jax.default_matmul_precision("highest"):
        batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0, seed=1234)))
        batch = {k: batch[k] for k in keys}
        for name in ("float32", "bfloat16"):
            jt = _jax_trainer(_precision(config, name))
            if name == "float32":
                state0 = jax.device_get(jt.init_state(jax.random.PRNGKey(0), batch))
            jt._ensure_autoencoder()  # what init_state does first
            _, m = jt.train_step(_fresh(state0), batch, 1)
            runs[name] = m.to_host()
    trainer = _port_trainer(_precision(config, "bfloat16"))
    trainer.load_state_tree(state0)
    port = {k: float(v) for k, v in trainer.train_step(to_device(batch, "cpu"), 1).items()}
    return dict(config=config, batch=batch, state0=state0, jax=runs, port=port, trainer=trainer)


def test_predictor_step_metrics_follow_jax_bf16(am_runs):
    parted = _nearer_bf16(am_runs["port"], am_runs["jax"]["bfloat16"], am_runs["jax"]["float32"], "AM step", METRIC_RTOL)
    assert parted >= 1


def test_predictor_masters_fp32_and_teacher_rounded(am_runs):
    trainer = am_runs["trainer"]
    assert all(p.dtype == torch.float32 for p in trainer.predictor.parameters())
    teacher = trainer.frozen_autoencoder()
    assert all(p.dtype == torch.bfloat16 for p in teacher.parameters())  # the JAX trainer casts its params
    for q in teacher.quantizer.quantizer:  # its codebook is no param: fp32
        assert q.embed.dtype == q.cluster_size.dtype == q.embed_avg.dtype == torch.float32


# -------------------------------------------------------------- the census


def test_autoencoder_forward_census_matches_jax(vq_runs):
    config, batch, state0 = vq_runs["config"], vq_runs["batch"], vq_runs["state0"]
    jae = build_task(config, mode="train").networks["autoencoder"]
    starts = np.zeros(4, np.int32)

    def fwd(params, codebook, mel):
        out, _ = jae.apply({"params": j_cast_floats(params, jnp.bfloat16), "codebook": codebook},
                           j_cast_floats(mel, jnp.bfloat16), batch["mel_length"], warmup=False,
                           window_starts=starts, window_frames=8, deterministic=False, mutable=["codebook"],
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return out["decoder_outputs"]

    want = jax_census(fwd, state0["params"]["autoencoder"], state0["codebook"], batch["mel"])
    trainer = _port_trainer(_precision(config, "bfloat16"))
    W.train_state_from_jax(state0, trainer.ae, trainer.disc)
    bind_generator(trainer.ae, torch.Generator().manual_seed(0))
    mel = torch.as_tensor(batch["mel"])
    with Census() as census:
        functional(trainer.ae, torch.bfloat16)(cast_floats(mel, torch.bfloat16), torch.as_tensor(batch["mel_length"]),
                                               window_starts=torch.as_tensor(starts), window_frames=8)
    assert dict(census.counts) == want
    assert want[("product", ("bfloat16", "bfloat16"))] == 1  # in_linear: the table's fp32 sum promotes the rest


def test_predictor_forward_census_matches_jax(am_runs):
    config, batch, state0 = am_runs["config"], am_runs["batch"], am_runs["state0"]
    trainer = am_runs["trainer"]
    t_batch = to_device(batch, "cpu")
    with torch.no_grad():
        q = trainer.teacher_states(t_batch)
    feat = [x.float().numpy() for x in q["quantizer_outputs"]]
    lengths = [x.numpy().astype(np.int32) for x in q["quantizer_lengths"]]
    jpred = build_task(config, mode="train").networks["predictor"]

    def fwd(params):
        out = jpred.apply({"params": j_cast_floats(params, jnp.bfloat16)}, batch["text"], batch["text_length"],
                          dur=batch["dur"], feat=feat, feat_length=lengths, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(1)})
        return out["feat"]

    want = jax_census(fwd, state0["params"]["predictor"])
    pred = _port_trainer(_precision(config, "bfloat16")).predictor
    pred.load_state_dict(trainer.predictor.state_dict())
    bind_generator(pred, torch.Generator().manual_seed(0))
    with Census() as census:
        functional(pred, torch.bfloat16)(t_batch["text"], t_batch["text_length"], dur=t_batch["dur"],
                                         feat=[torch.as_tensor(f) for f in feat],
                                         feat_length=[torch.as_tensor(n) for n in lengths])
    assert dict(census.counts) == want


# ---------------------------------------------------------------- inference


def _bf16_tasks(path):
    ck = load_checkpoint(path)
    config = Config(ck["config"])
    config["precision"] = "bfloat16"
    jtask = build_task(config, mode="infer")
    jtask.load_variables(ck["state"])
    tck = t_load_checkpoint(path)
    tconfig = TConfig(tck["config"])
    tconfig["precision"] = "bfloat16"
    ttask = t_build_task(tconfig, device="cpu")
    ttask.load_variables(tck["state"])
    return jtask, ttask


def test_analysis_synthesis_follows_jax_bf16(tiny_pair):
    rng = np.random.default_rng(2)
    batch = {"mel": rng.normal(size=(2, 16, MEL_DIM)).astype(np.float32), "mel_length": np.array([16, 10])}
    with jax.default_matmul_precision("highest"):
        jtask, ttask = _bf16_tasks(tiny_pair["ae"])
        want = jtask.infer_step(batch)
        jtask32 = build_task(Config(load_checkpoint(tiny_pair["ae"])["config"]), mode="infer")
        jtask32.load_variables(load_checkpoint(tiny_pair["ae"])["state"])
        want32 = jtask32.infer_step(batch)
    ae = ttask.networks["autoencoder"]
    assert all(p.dtype == torch.bfloat16 for p in ae.parameters())
    assert all(b.dtype == torch.float32 for n, b in ae.named_buffers() if b is not None and b.is_floating_point())
    got = ttask.infer_step(batch)
    parted = 0
    for a, b, c in zip(got["wav"], want["wav"], want32["wav"]):
        np.testing.assert_allclose(a, np.asarray(b), atol=WAV_TOL, rtol=0)
        parted += float(np.abs(np.asarray(b) - np.asarray(c)).max()) > 10 * WAV_TOL
    assert parted  # the rounded weights do change the waveform


@pytest.mark.skipif(not os.path.exists(FIXTURE), reason="trained fixture not present")
def test_fixture_analysis_synthesis_follows_jax_bf16():
    """The trained CSMSC autoencoder under bf16: port vs JAX's bf16 task,
    beside what bf16 does to JAX's own decode (its fp32 task)."""
    T = 64
    rng = np.random.default_rng(0)
    batch = {"mel": rng.normal(size=(1, T, 80)).astype(np.float32) * 0.5, "mel_length": np.array([T], np.int32)}
    with jax.default_matmul_precision("highest"):
        jtask, ttask = _bf16_tasks(FIXTURE)
        want = jtask.analysis_synthesis(batch)["wav"][0]
        ae, v = jtask.networks["autoencoder"], jtask.variables["autoencoder"]
        jq = jax.jit(lambda v, m, l: ae.apply(v, m, l, method="analysis"))(v, batch["mel"], batch["mel_length"])
        jtask32 = build_task(Config(load_checkpoint(FIXTURE)["config"]), mode="infer")
        jtask32.load_variables(load_checkpoint(FIXTURE)["state"])
        want32 = jtask32.analysis_synthesis(batch)["wav"][0]
    got = ttask.analysis_synthesis(batch)["wav"][0]
    with torch.inference_mode():
        tq = ttask.networks["autoencoder"].analysis(torch.as_tensor(batch["mel"]), torch.as_tensor(batch["mel_length"]))
    for a, b in zip(tq["quantizer_indices"], jq["quantizer_indices"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got, np.asarray(want), atol=FIXTURE_WAV_TOL, rtol=0)
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    # observed: port vs JAX bf16 2.6e-6, JAX bf16 vs JAX fp32 0.027
    assert rel(got, np.asarray(want)) < 0.01 * rel(np.asarray(want), np.asarray(want32))


@pytest.mark.parametrize("forced", [True, False], ids=["forced-durations", "predicted-durations"])
def test_predict_follows_jax_bf16(tiny_pair, forced):
    batch = _batch(forced)
    with jax.default_matmul_precision("highest"):
        jtask, ttask = _bf16_tasks(tiny_pair["am"])
        want = jtask.infer_step(batch)
    got = ttask.infer_step(batch)
    assert all(p.dtype == torch.bfloat16 for p in ttask.networks["predictor"].parameters())
    np.testing.assert_array_equal(got["duration"], np.asarray(want["duration"]))
    np.testing.assert_array_equal(got["mel_length"], np.asarray(want["mel_length"]))
    for a, b in zip(got["embedding"], want["embedding"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(got["wav"], want["wav"]):
        np.testing.assert_allclose(a, np.asarray(b), atol=WAV_TOL, rtol=0)


def test_predict_stream_and_engine_under_bf16(tiny_pair):
    """The streamed chunks of a bf16 task join to its ``predict``; the
    batching engine warms every shape on it and serves a request and a
    stream of the same text alike, with no cold shape."""
    tck = t_load_checkpoint(tiny_pair["am"])
    tconfig = TConfig(tck["config"])
    tconfig["precision"] = "bfloat16"
    ttask = t_build_task(tconfig, device="cpu")
    ttask.load_variables(tck["state"])
    ttask.pre_infer()
    batch = _batch(True)
    whole = ttask.predict(batch)
    meta, chunks = ttask.predict_stream(batch, chunk_frames=8)
    wav = np.concatenate(list(chunks), axis=1)
    for i, w in enumerate(whole["wav"]):
        np.testing.assert_allclose(wav[i, : meta["wav_length"][i]], w, atol=1e-6, rtol=0)
    eng = BatchingEngine(ttask, sample_rate=1600, batch_size=2, text_length=16, max_frames=64,
                         stream_chunk_frames=8, window_ms=0.0).start(warmup={})
    try:
        assert eng.warmup_s > 0
        blocking = eng.synthesize("3_1 5_2 7_0 2_1", timeout=120)
        streamed = np.concatenate(list(eng.synthesize_stream("3_1 5_2 7_0 2_1", timeout=120)))
        snap = eng.snapshot()
    finally:
        eng.stop()
    assert blocking.shape[0] > 0 and np.isfinite(blocking).all()
    np.testing.assert_allclose(streamed, blocking, atol=1e-6, rtol=0)
    assert snap["cold_shapes"] == 0 and snap["errors"] == 0 and snap["requests"] >= 1


def test_int8_decoder_under_bf16_raises(tiny_pair):
    """``--int8`` under bf16 (ROADMAP A11a, once refused): the int8 decoder is built
    in the compute dtype, as the JAX task builds it, and its analysis-
    synthesis follows JAX's bf16 int8 decode (``tests/test_torch_legacy_tts.py``
    bounds it site by site; 5e-2 relative L2 here, observed: equal)."""
    rng = np.random.default_rng(8)
    batch = {"mel": rng.normal(size=(2, 16, MEL_DIM)).astype(np.float32), "mel_length": np.array([16, 9])}
    jtask, ttask = _bf16_tasks(tiny_pair["ae"])
    jtask.int8_decoder = ttask.int8_decoder = True
    with jax.default_matmul_precision("highest"):
        want = jtask.infer_step(batch)["wav"]
    got = ttask.infer_step(batch)["wav"]
    assert ttask._int8().dtype == torch.bfloat16
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape and np.abs(b).max() > 1e-3
        assert np.linalg.norm(a - b) <= 5e-2 * np.linalg.norm(b)


# ------------------------------------------------------------------ QS-TTS


def test_emb_vqgan_trainer_follows_jax_bf16(tmp_path):
    """EmbVQGANTrainer under bf16 (ECAPA's batch norms over the bf16 mel,
    pitch / energy, the prosody estimator): one supervised step from one JAX
    state within METRIC_RTOL of JAX's bf16 step and nearer it than the fp32
    step (the port's, which ``test_torch_emb_train.py`` holds to JAX's);
    then the decode and GAN phases; masters, codebooks and BN statistics
    stay fp32."""
    d = str(tmp_path)
    write_tiny_emb_dataset(d)
    config = tiny_emb_config(d)
    config["trainer"]["stft_loss_supervised_step"] = 2
    config["save_checkpoint_dir"] = d + "/ckpt"
    ae = config["task"]["autoencoder"]
    ae["encoder_config"]["dropout"] = ae["quantizer_config"]["dropout"] = 0.0
    ae["quantizer_config"]["prior_config"]["p_dropout"] = 0.0
    keys = ("emb", "emb_length", "pitch", "energy", "mel", "wav")
    with jax.default_matmul_precision("highest"):
        jt = _jax_trainer(_precision(config, "bfloat16"))
        batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0)))
        batch = {k: batch[k] for k in keys}
        state0 = jax.device_get(jt.init_state(jax.random.PRNGKey(0), batch))
        _, m = jt.train_step(_fresh(state0), batch, 1)
        want = m.to_host()
    t_batch = to_device(batch, "cpu")
    runs = {}
    for name in ("float32", "bfloat16"):
        trainer = _port_trainer(_precision(config, name))
        trainer.load_state_tree(state0)
        runs[name] = {k: float(v) for k, v in trainer.train_step(t_batch, 1).items()}
    assert _nearer_bf16(runs["bfloat16"], want, runs["float32"], "emb supervised step", EMB_RTOL) >= 1
    windows = (np.array([0, 2]), np.array([0, 1]))
    later = [trainer.train_step(t_batch, it, windows=windows) for it in (2, 3)]
    assert "stft_loss" in later[0] and "d_loss" in later[1]
    assert all(np.isfinite(float(v)) for m in later for v in m.values())
    for module in (trainer.ae, trainer.disc, trainer.prosody):
        for n, t in list(module.named_parameters()) + list(module.named_buffers()):
            assert t is None or not t.is_floating_point() or t.dtype == torch.float32, n


def test_nasyn_predictor_trainer_runs_fp32_under_bf16(tmp_path):
    d = str(tmp_path)
    write_tiny_emb_dataset(d)
    emb_cfg = tiny_emb_config(d)
    synth = _port_trainer(emb_cfg)
    for i, m in enumerate((synth.ae, synth.disc, synth.prosody)):
        W.init_random(m, 1234 + i)
    teacher = os.path.join(d, "synth.ckpt")
    t_save_checkpoint(teacher, synth.state_tree(), 1, emb_cfg.to_dict())
    config = _am_no_dropout(tiny_am_config(d, teacher))
    config["task"]["_name"] = "NASynTTSv2"
    config["task"]["predictor"]["_name"] = "NASynCascadeFastSpeech"
    config["trainer"]["_name"] = "NASynEmbFSTrainer"
    config["dataset"]["feature"] = ["text", "dur", "emb", "pitch", "energy"]
    config["dataset"]["feature_path"] = [f"{d}/phone.txt", f"{d}/dur.txt", f"{d}/emb/{{}}.npy",
                                         f"{d}/pitch/{{}}.npy", f"{d}/energy/{{}}.npy"]
    config["dataset"]["dimension"] = [2, 1, 12, 1, 1]
    config["dataset"]["frameshift"] = [None, None, 4, 4, 4]
    config["dataset"]["padding_value"] = [0, 0, 0, 0, 0]
    batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0)))
    batch = to_device({k: batch[k] for k in ("text", "text_length", "dur", "emb", "emb_length", "pitch", "energy")},
                      "cpu")
    jt = get_trainer("NASynEmbFSTrainer")(_precision(config, "bfloat16"), build_task(config, mode="train"),
                                          mesh=make_mesh(1), **component_kwargs(config.trainer))
    assert not hasattr(jt, "compute_dtype")  # the JAX trainer never reads the key
    runs = {}
    for name in ("float32", "bfloat16"):
        trainer = _port_trainer(_precision(config, name))
        W.init_random(trainer.predictor, 7)
        assert trainer.compute_dtype == torch.float32
        runs[name] = {k: float(v) for k, v in trainer.train_step(batch, 1).items()}
        assert all(p.dtype == torch.float32 for p in trainer.frozen_autoencoder().parameters())
    assert runs["bfloat16"] == runs["float32"]
