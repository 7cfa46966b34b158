"""The port's tools and entry-point options against the JAX package's, on
the CPU: checkpoint retention (``checkpoint_keep_interval``; the orbax
backend refused), ``tools.strip_checkpoint``, ``tools.convert_torch_checkpoint``,
``synthesize --static-frames``, ``train --profile`` and ``tools.load_test``.

Tolerances.
  * retention, strip and convert: equal names, equal trees (dtype and value
    of every leaf).
  * ``synthesize --static-frames`` port vs the JAX ``synthesize.py``: both
    write 16-bit PCM; 1e-4 on the samples (3 LSB), as the port's predict is
    held to JAX's (``test_torch_slice.py::test_predict_matches_jax``).
  * the port's static decode against its own dynamic decode of a text whose
    frames plus ``padding_reach_frames`` fit its dynamic bucket: 1e-5 (the
    same weights on other padded lengths; attention sums over the padded
    length in another blocking).
  * a stripped checkpoint through the port's infer: equal (without
    ``--f16``).
"""

import json
import os
import pickle
import sys
import threading

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from msmctts_tpu.config import Config
from msmctts_tpu.registry import get_network
from msmctts_tpu.utils import torch_compat as tc
from msmctts_tpu.utils.checkpoint import clean_checkpoint_directory as j_clean
from msmctts_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from msmctts_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from msmctts_tpu.models.predictor import MultiStagePredictor
from msmctts_tpu_torch import serve as t_serve
from msmctts_tpu_torch import synthesize as t_synthesize
from msmctts_tpu_torch import train as t_train
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.serving import BatchingEngine
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.tools import convert_torch_checkpoint as t_convert
from msmctts_tpu_torch.tools import load_test as t_load
from msmctts_tpu_torch.tools import strip_checkpoint as t_strip
from msmctts_tpu_torch.utils.checkpoint import clean_checkpoint_directory as t_clean
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint as t_load_checkpoint
from msmctts_tpu_torch.utils.checkpoint import read_checkpoint
from tests.test_torch_slice import _gains, tiny_pair  # noqa: F401  (module fixture)
from tests.test_torch_train_slice import _flat, _port_trainer
from tests.tiny import FRAMESHIFT, MEL_DIM, tiny_ae_config, tiny_am_config, write_tiny_dataset

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "csmsc_ae_r5.f16.ckpt")
SR = 1600  # the tiny corpus's rate
WAV_TOL = 1e-4
STATIC_TOL = 1e-5


def _jax(fn):
    with jax.default_matmul_precision("highest"):
        return fn()


def _names(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else None


def _same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    return len(fa)


# ------------------------------------------------------- checkpoint retention


LISTINGS = {
    "every-step": ([1, 2, 3, 4, 5], 2, 2),
    "round-steps": ([10, 20, 25, 30, 35, 40, 45], 10, 2),
    "keep-one": ([3, 6, 7, 9, 12], 3, 1),
    "keep-three": ([1, 2, 3, 4, 5, 6, 7], 4, 3),
    "interval-0": ([1, 2, 3, 4], 0, 2),
    "fewer-than-kept": ([5], 2, 2),
    "empty": ([], 2, 2),
}


@pytest.mark.parametrize("name", sorted(LISTINGS))
def test_clean_checkpoint_directory_matches_jax(tmp_path, name):
    """On the same listing (``model_<step>`` pickles beside an unfinished
    ``.tmp``, a log and a foreign file) both functions leave the same names."""
    steps, interval, keep = LISTINGS[name]
    dirs = []
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        for s in steps:
            (d / f"model_{s}").write_bytes(b"x")
        for extra in ("model_11.tmp", "train_rank0_x.log", "notes.txt"):
            (d / extra).write_bytes(b"x")
        dirs.append(str(d))
    j_clean(dirs[0], interval, keep_last=keep)
    t_clean(dirs[1], interval, keep_last=keep)
    assert _names(dirs[0]) == _names(dirs[1])
    assert {"model_11.tmp", "train_rank0_x.log", "notes.txt"} <= set(_names(dirs[1]))
    kept = [s for s in steps if f"model_{s}" in _names(dirs[1])]
    assert kept[-keep:] == steps[-keep:] if steps else kept == []
    t_clean(str(tmp_path / "missing"), interval)  # no directory: nothing to do, as in JAX


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tools_corpus"))
    write_tiny_dataset(d)
    return d


def test_trainer_keeps_what_the_jax_trainer_keeps(corpus, tmp_path):
    """5 steps with a checkpoint every step and ``checkpoint_keep_interval:
    2``: the port's save dir holds the names JAX's function leaves when it
    runs after each of the same saves (``model_2``, ``model_4``,
    ``model_5``); on the parent tree the port kept all five."""
    config = tiny_ae_config(corpus)
    config["save_checkpoint_dir"] = str(tmp_path / "ckpt")
    config["iters_per_checkpoint"] = 1
    config["checkpoint_keep_interval"] = 2
    _port_trainer(config.to_dict()).train(max_steps=5, log_every=5)
    got = [n for n in _names(config["save_checkpoint_dir"]) if n.startswith("model_")]

    ref = tmp_path / "jax"
    ref.mkdir()
    for it in range(1, 6):  # the JAX trainer's save: write, then clean
        (ref / f"model_{it}").write_bytes(b"x")
        j_clean(str(ref), 2)
    assert got == _names(str(ref)) == ["model_2", "model_4", "model_5"]


def test_orbax_backend_is_refused_when_the_trainer_is_built(corpus):
    config = tiny_ae_config(corpus)
    config["checkpoint_backend"] = "orbax"
    with pytest.raises(NotImplementedError, match="A7c"):
        _port_trainer(config.to_dict())
    config["checkpoint_backend"] = "pickle"
    assert _port_trainer(config.to_dict()).iteration == 0


# ------------------------------------------------------------------ strip


@pytest.fixture(scope="module")
def jax_training_checkpoint(tmp_path_factory):
    """A tiny AE checkpoint as a JAX trainer writes one: params with a
    discriminator, the codebook, optax states and the step."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    cfg = tiny_ae_config(d)
    node = cfg.task["autoencoder"]
    ae = get_network(node["_name"])(**{k: v for k, v in node.items() if not k.startswith("_")})
    av = jax.device_get(jax.jit(lambda k: ae.init({"params": k, "dropout": k}, np.zeros((1, 8, MEL_DIM), np.float32),
                                                  np.array([8], np.int32), deterministic=True))(jax.random.PRNGKey(0)))
    params = {"autoencoder": _gains(av["params"], np.random.default_rng(0)),
              "discriminator": {"conv": {"kernel": np.ones((3, 2, 4), np.float32)}}}
    tx = optax.adamw(2e-4)
    state = {"params": params, "codebook": av["codebook"],
             "opt_state": {"ae": tx.init(params["autoencoder"]), "d": tx.init(params["discriminator"])},
             "step": np.int32(7)}
    path = os.path.join(d, "model_7")
    j_save_checkpoint(path, state, 7, cfg.to_dict())
    return path


def _jax_strip(src, out, f16, monkeypatch):
    import tools.strip_checkpoint as j_strip

    monkeypatch.setattr(sys, "argv", ["strip_checkpoint.py", src, "-o", out] + (["--f16"] if f16 else []))
    j_strip.main()


@pytest.mark.parametrize("f16", [False, True], ids=["as-stored", "f16"])
@pytest.mark.parametrize("source", ["jax-tiny", "fixture"])
def test_strip_matches_the_jax_tool(jax_training_checkpoint, tmp_path, monkeypatch, source, f16):
    src = jax_training_checkpoint if source == "jax-tiny" else FIXTURE
    if source == "fixture" and not os.path.exists(FIXTURE):
        pytest.skip("trained fixture not present")
    got_path, want_path = str(tmp_path / "port"), str(tmp_path / "jax")
    t_strip.main([src, "-o", got_path] + (["--f16"] if f16 else []))
    _jax_strip(src, want_path, f16, monkeypatch)
    with open(got_path, "rb") as f:
        got = pickle.load(f)
    want = j_load_checkpoint(want_path)
    assert (got["iteration"], got["format"]) == (want["iteration"], want["format"])
    assert got["config"] == want["config"]
    n = _same_tree(got["state"], want["state"])
    assert n > 50 and {"params", "codebook"} <= set(got["state"]) <= {"params", "codebook", "model_state"}
    assert "discriminator" not in got["state"]["params"]
    dtypes = {v.dtype for v in _flat(got["state"]).values()}
    if f16 or source == "fixture":
        assert np.dtype(np.float16) in dtypes and np.dtype(np.float32) not in dtypes
    else:
        assert np.dtype(np.float32) in dtypes


def test_a_port_checkpoint_stripped_loads_in_jax_and_decodes_alike(corpus, tmp_path):
    config = tiny_ae_config(corpus)
    config["save_checkpoint_dir"] = str(tmp_path / "ckpt")
    trainer = _port_trainer(config.to_dict()).train(max_steps=1, log_every=1)
    full = os.path.join(config["save_checkpoint_dir"], "model_1")
    assert {"torch_opt_state", "torch_rng"} <= set(read_checkpoint(full)["state"])
    rng = np.random.default_rng(3)
    batch = {"mel": rng.normal(size=(2, 32, MEL_DIM)).astype(np.float32), "mel_length": np.array([32, 20], np.int32)}

    def decode(path):
        ck = t_load_checkpoint(path)
        task = t_build_task(TConfig(ck["config"]), device="cpu")
        task.load_variables(ck["state"])
        return task.infer_step(batch)["wav"]

    want = decode(full)
    for f16 in (False, True):
        out = str(tmp_path / f"stripped_{int(f16)}")
        t_strip.main([full, "-o", out, "--f16"] if f16 else [full, "-o", out])
        jck = j_load_checkpoint(out)  # the JAX package reads it
        assert set(jck["state"]) == {"params", "codebook", "model_state"} and set(jck["state"]["params"]) == {"autoencoder"}
        assert jck["iteration"] == trainer.iteration == 1
        leaves = _flat({k: jck["state"][k] for k in ("params", "codebook")}).values()
        assert {v.dtype for v in leaves} == {np.dtype(np.float16 if f16 else np.float32)}
    # a seeded codebook after one step holds codewords beyond float16's range (an EMA over
    # near-empty clusters), so only the float32 copy decodes here: exactly as the original
    for a, b in zip(decode(str(tmp_path / "stripped_0")), want):
        np.testing.assert_array_equal(a, b)
    assert max(float(np.abs(w).max()) for w in want) > 0


# ---------------------------------------------------------------- convert


def _reference_state_dict(tmp, n_heads):
    """A seeded task state dict in the reference's names: the tiny AE
    (``n_heads`` codebook heads) and AM initialised in JAX and named by
    ``torch_compat``'s inverse converters, plus the port's discriminator."""
    cfg = tiny_ae_config(tmp)
    node = cfg.task["autoencoder"]
    node["quantizer_config"]["n_heads"] = n_heads
    ae = get_network(node["_name"])(**{k: v for k, v in node.items() if not k.startswith("_")})
    key = jax.random.PRNGKey(n_heads)
    av = jax.device_get(jax.jit(lambda k: ae.init({"params": k, "dropout": k}, np.zeros((1, 8, MEL_DIM), np.float32),
                                                  np.array([8], np.int32), deterministic=True))(key))
    pnode = tiny_am_config(tmp, "unused").task["predictor"]
    pred = MultiStagePredictor(**{k: v for k, v in pnode.items() if not k.startswith("_")})
    pv = jax.device_get(jax.jit(lambda k: pred.init(k, np.ones((1, 8, 2), np.int32), np.array([8], np.int32),
                                                    dur=np.ones((1, 8), np.float32), max_frames=16))(key))
    disc = t_build_task(TConfig(cfg.to_dict()), device="cpu", mode="train").networks["discriminator"]
    sd = {f"autoencoder.{k}": v for k, v in tc.msmc_vqgan_inv(av).items()}
    sd.update({f"predictor.{k}": v for k, v in tc.multi_stage_predictor_inv(pv["params"]).items()})
    sd.update({f"discriminator.{k}": v.numpy() for k, v in disc.state_dict().items()})
    return {k: np.asarray(v) for k, v in sd.items()}


@pytest.mark.parametrize("n_heads", [2, 1], ids=["multi-head", "one-head"])
def test_convert_matches_the_jax_tool(tmp_path, monkeypatch, capsys, n_heads):
    import tools.convert_torch_checkpoint as j_convert

    sd = _reference_state_dict(str(tmp_path), n_heads)
    stage0 = [k for k in sd if k.startswith("autoencoder.quantizer.quantizer.0.") and k.endswith(".embed")]
    assert len(stage0) == n_heads  # per-head buffers, or one head's [d, K]
    torch_path = str(tmp_path / "ref_model_9")
    torch.save({"model": {k: torch.tensor(v) for k, v in sd.items()}, "iteration": 9}, torch_path)
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(tiny_ae_config(str(tmp_path)).to_dict(), f)
    got_path, want_path = str(tmp_path / "port"), str(tmp_path / "jax")

    capsys.readouterr()
    t_convert.main(["--torch", torch_path, "--config", cfg_path, "--out", got_path])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["convert_torch_checkpoint.py", "--torch", torch_path, "--config", cfg_path,
                                      "--out", want_path])
    j_convert.main()
    jax_out = capsys.readouterr().out
    note = "note: skipping non-convertible modules: discriminator"
    assert note in port_out and note in jax_out
    got, want = t_load_checkpoint(got_path), j_load_checkpoint(want_path)
    assert got["iteration"] == want["iteration"] == 9 and got["config"] == want["config"]
    assert _same_tree(got["state"], want["state"]) > 50
    assert set(got["state"]["params"]) == {"autoencoder", "predictor"}
    assert got["state"]["codebook"]["quantizer"]["vq_0"]["embed"].shape[0] == n_heads

    # nothing convertible: the same exit in both
    for convert in (t_convert.convert, j_convert.convert):
        with pytest.raises(SystemExit, match="no convertible modules found in the checkpoint"):
            convert({k: v for k, v in sd.items() if k.startswith("discriminator.")})


def test_convert_refuses_quantizer_batch_norm(tmp_path):
    """A reference checkpoint with ``norm: True`` (each stage's BatchNorm1d
    statistics at ``preprocessor.<i>.3``, once refused: ROADMAP A7b) and learned
    upsamplers (``transposed_conv.<i>``): converted as the JAX tool converts
    it, the statistics into ``model_state.batch_stats``."""
    import tools.convert_torch_checkpoint as j_convert

    rng = np.random.default_rng(5)
    sd = _reference_state_dict(str(tmp_path), 2)
    for i in range(2):
        sd[f"autoencoder.quantizer.preprocessor.{i}.3.running_mean"] = rng.normal(size=16).astype(np.float32)
        sd[f"autoencoder.quantizer.preprocessor.{i}.3.running_var"] = rng.uniform(0.5, 2, size=16).astype(np.float32)
        sd[f"autoencoder.quantizer.preprocessor.{i}.3.num_batches_tracked"] = np.array(7)
        k = (4, 3)[i]
        sd[f"autoencoder.quantizer.transposed_conv.{i}.weight_v"] = rng.normal(size=(16, 16, k)).astype(np.float32)
        sd[f"autoencoder.quantizer.transposed_conv.{i}.weight_g"] = rng.uniform(0.5, 1.5, size=(16, 1, 1)).astype(np.float32)
        sd[f"autoencoder.quantizer.transposed_conv.{i}.bias"] = rng.normal(size=16).astype(np.float32)
    got, want = t_convert.convert(sd), j_convert.convert(sd)
    assert _same_tree(got, want) > 50
    assert sorted(got["model_state"]["batch_stats"]["quantizer"]) == ["prenorm_0", "prenorm_1"]
    assert {"up_0", "up_1"} <= set(got["params"]["autoencoder"]["quantizer"])


# ------------------------------------------------------ synthesize --static-frames


def _text_within_its_bucket(task):
    """A phone string whose predicted frames plus the task's padding reach
    fit the frame bucket a dynamic ``predict`` picks for it."""
    from msmctts_tpu_torch.data.datasets import FRAME_BUCKETS, bucket_length

    reach = task.padding_reach_frames()
    rng = np.random.default_rng(4)
    for _ in range(200):
        n = int(rng.integers(3, 12))
        tokens = np.stack([rng.integers(1, 20, n), rng.integers(0, 5, n)], -1)
        text = " ".join(f"{a}_{b}" for a, b in tokens)
        total = int(task._predict_phase1({"text": tokens[None], "text_length": np.array([n])})["total"][0])
        if total + reach <= bucket_length(total, FRAME_BUCKETS):
            return text, total, bucket_length(total, FRAME_BUCKETS)
    raise AssertionError("no such text")


def test_synthesize_static_frames_matches_jax(tiny_pair, tmp_path, monkeypatch):
    from scipy.io import wavfile

    import synthesize as j_synthesize
    from msmctts_tpu_torch.data.datasets import FRAME_BUCKETS, bucket_length

    ck = t_load_checkpoint(tiny_pair["am"])
    task = t_build_task(TConfig(ck["config"]), device="cpu")
    task.load_variables(ck["state"])
    text, total, bucket = _text_within_its_bucket(task)
    static = 2 * bucket
    built = []  # each run's task: its ("syn", text bucket, frame bucket) shape says where it decoded
    monkeypatch.setattr(t_synthesize, "build_task", lambda *a, **kw: built.append(t_build_task(*a, **kw)) or built[-1])
    dynamic_wav = t_synthesize.main(["-m", tiny_pair["am"], "--text", text, "-o", str(tmp_path / "dyn.wav"),
                                     "--device", "cpu"])
    static_wav = t_synthesize.main(["-m", tiny_pair["am"], "--text", text, "-o", str(tmp_path / "port.wav"),
                                    "--static-frames", str(static), "--device", "cpu"])
    decoded = [sorted(s[2] for s in t.shapes if s[0] == "syn") for t in built]
    assert decoded == [[bucket], [bucket_length(static, FRAME_BUCKETS)]] and bucket_length(static, FRAME_BUCKETS) != bucket
    assert built[1].static_max_frames == static and built[0].static_max_frames is None
    monkeypatch.setenv("MSMCTTS_COMPILE_CACHE", "0")
    monkeypatch.setattr(sys, "argv", ["synthesize.py", "-m", tiny_pair["am"], "--text", text,
                                      "-o", str(tmp_path / "jax.wav"), "--static-frames", str(static)])
    _jax(j_synthesize.main)
    _, port_pcm = wavfile.read(str(tmp_path / "port.wav"))
    sr, jax_pcm = wavfile.read(str(tmp_path / "jax.wav"))
    assert sr == SR and static_wav.shape == dynamic_wav.shape == (total * FRAMESHIFT,) == port_pcm.shape == jax_pcm.shape
    assert float(np.abs(static_wav).max()) > 1e-2
    np.testing.assert_allclose(port_pcm / 32767.0, jax_pcm / 32767.0, atol=WAV_TOL, rtol=0)
    np.testing.assert_allclose(static_wav, dynamic_wav, atol=STATIC_TOL, rtol=0)


# ---------------------------------------------------------- train --profile


def _profiled_run(corpus, save_dir, profile_dir=None, max_steps=4, **window):
    config = tiny_ae_config(corpus)
    config["save_checkpoint_dir"] = save_dir
    trainer = _port_trainer(config.to_dict())
    trainer.train(max_steps=max_steps, log_every=max_steps, profile_dir=profile_dir, **window)
    return trainer


def test_profile_writes_a_trace_and_leaves_the_state_alone(corpus, tmp_path):
    prof = str(tmp_path / "prof")
    plain = _profiled_run(corpus, str(tmp_path / "plain"))
    traced = _profiled_run(corpus, str(tmp_path / "traced"), prof, profile_start=2, profile_steps=2)
    assert _names(prof) == ["steps_2-3_rank0.json"]
    trace = json.load(open(os.path.join(prof, "steps_2-3_rank0.json")))
    names = {ev.get("name", "") for ev in trace["traceEvents"]}
    assert any("conv" in n for n in names)  # the steps' operators are in it
    a, b = plain.task.networks, traced.task.networks
    for name in a:
        sa, sb = a[name].state_dict(), b[name].state_dict()
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (name, k)
    assert torch.equal(plain.generator.get_state(), traced.generator.get_state())
    log = [f for f in os.listdir(tmp_path / "traced") if f.endswith(".log")]
    assert "profiler trace written to" in open(tmp_path / "traced" / log[0]).read()


def test_a_run_that_stops_inside_the_window_writes_its_trace(corpus, tmp_path):
    prof = str(tmp_path / "prof")
    _profiled_run(corpus, str(tmp_path / "ckpt"), prof, max_steps=3, profile_start=2, profile_steps=5)
    assert _names(prof) == ["steps_2-3_rank0.json"]
    assert json.load(open(os.path.join(prof, "steps_2-3_rank0.json")))["traceEvents"]


def test_train_cli_profile_flag(corpus, tmp_path, monkeypatch):
    """``--profile DIR`` reaches the trainer with the JAX CLI's window
    (from step 10, 5 steps)."""
    import inspect

    from msmctts_tpu.training.base_trainer import BaseTrainer as JBaseTrainer
    from msmctts_tpu_torch.training.base_trainer import BaseTrainer

    port = inspect.signature(BaseTrainer.train).parameters
    ref = inspect.signature(JBaseTrainer.train).parameters
    assert [(port[k].default, k) for k in ("profile_start", "profile_steps")] == \
        [(ref[k].default, k) for k in ("profile_start", "profile_steps")] == [(10, "profile_start"), (5, "profile_steps")]
    seen = {}
    monkeypatch.setattr(BaseTrainer, "train", lambda self, **kw: seen.update(kw))
    config = tiny_ae_config(corpus)
    cfg_path = str(tmp_path / "ae.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config.to_dict(), f)
    t_train.main(["-c", cfg_path, "--device", "cpu", "--max-steps", "3", "--profile", str(tmp_path / "p")])
    assert seen == {"max_steps": 3, "log_every": 50, "profile_dir": str(tmp_path / "p")}


# -------------------------------------------------------------- load_test


def test_load_test_against_an_in_process_daemon(tiny_pair):
    from http.server import ThreadingHTTPServer

    ck = t_load_checkpoint(tiny_pair["am"])
    task = t_build_task(TConfig(ck["config"]), device="cpu")
    task.load_variables(ck["state"])
    eng = BatchingEngine(task, sample_rate=SR, batch_size=4, text_length=32, max_frames=256, window_ms=5.0,
                         stream_chunk_frames=8).start(warmup={"text_lengths": [32]})
    ready = threading.Event()
    ready.set()
    server = ThreadingHTTPServer(("127.0.0.1", 0), t_serve.make_handler(eng, ready, request_timeout=120))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        report = t_load.main(["--url", f"http://127.0.0.1:{server.server_port}", "--levels", "1", "2",
                              "--requests", "4", "--streaming-requests", "2", "--n-symbols", "20", "5",
                              "--min-tokens", "3", "--max-tokens", "10", "--sample-rate", str(SR), "--timeout", "120"])
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()
    assert [r["concurrency"] for r in report["levels"]] == [1, 2]
    for row in report["levels"]:
        assert row["requests"] == 4 and row["client_errors"] == 0 and row["latency_s"]["p50"] > 0
        window = row["server_window"]
        assert window["requests"] == 4 and window["errors"] == 0 and window["batches"] >= 1
        assert window["cold_shapes"] == window["kernel_builds"] == 0
    assert report["streaming"]["requests"] == 2 and report["streaming"]["ttfa_s"]["p50"] > 0
    assert report["cold_shapes_during_run"] == report["kernel_builds_during_run"] == 0
    assert "xla_compiles_during_run" not in report


def test_load_test_spawns_the_ports_daemon():
    cmd = t_load.spawn_command(["-m", "am.ckpt", "--port", "8093"])
    assert cmd == [sys.executable, "-m", "msmctts_tpu_torch.serve", "-m", "am.ckpt", "--port", "8093"]
