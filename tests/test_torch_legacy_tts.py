"""The legacy ``TTS`` task and the int8 decoder under ``precision:
bfloat16`` in the port against msmctts_tpu on the CPU.

``TTS`` (``msmctts_tpu/tasks.py:100-198``): a stand-in acoustic model
(one Dense from the batch's mel to 32 channels, registered in both
packages' registries, as ``tests/test_misc_surface.py`` registers one for
JAX) under the three ways the task ends: the tiny autoencoder's
``synthesis`` over the mel's per-stage chunks, pooled by the cumulative
``downsample_scales`` (the JAX task raises there, reading a flax submodule
outside ``apply``: the port is held to what that code computes, with the
scales read from the config); a HiFi-GAN ``vocoder``; the mel itself. Then
``python -m msmctts_tpu_torch.infer`` over a checkpoint of the task,
against the JAX task's ``infer_step`` on the same test list.

The int8 decoder under bf16 (``Int8Decoder(dtype=compute_dtype)``, as the
JAX task builds it): site by site on one input, both decoders calibrated on
it, the share of activation codes that differ from JAX's; then
``analysis_synthesis`` and ``predict`` of the tiny pair end to end.

Tolerances (JAX under matmul precision "highest").
  * TTS waveforms and mels: 1e-4 absolute (fp32, as ``test_torch_slice.py``
    holds the autoencoder).
  * bf16 int8, site by site on equal inputs: the port's activations are
    rounded to bf16 op by op, XLA's sometimes keeps a fused chain in more
    precision, so an activation near a code's rounding boundary can land in
    the next code: at most 1 % of a site's codes may differ, each by one
    step. The waveform from the same input: 2e-2 relative L2. Observed on
    the tiny pair: no code differs at any of the 11 sites, the waveforms
    are equal.
  * bf16 int8 end to end (``analysis_synthesis``, ``predict``): the
    decoder's bf16-rounded inputs may themselves part by a rounding step,
    so 5e-2 relative L2 (observed: equal), beside int8 against the bf16
    float decoder within JAX's bound 0.25 (observed 8.5e-3 to 1.09e-2).
"""

import os

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch
import yaml

import msmctts_tpu.ops.int8_generator as J
from msmctts_tpu import registry as j_registry
from msmctts_tpu.config import Config
from msmctts_tpu.data.loader import finite_loader as j_finite_loader
from msmctts_tpu.registry import get_network
from msmctts_tpu.tasks import build_task
from msmctts_tpu.training.base_trainer import build_dataset_from_config as j_build_dataset
from msmctts_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
import msmctts_tpu_torch.ops.int8_generator as T
from msmctts_tpu_torch import infer as t_infer
from msmctts_tpu_torch import registry as t_registry
from msmctts_tpu_torch import tasks as t_tasks
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.parallel.precision import Linear
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint as t_load_checkpoint
from tests.test_torch_slice import _batch, tiny_pair  # noqa: F401  (a fixture)
from tests.tiny import FRAMESHIFT, MEL_DIM, tiny_ae_config

torch.set_num_threads(2)

AM_NAME = "LegacyStandInAM"
AM_DIM = 32  # two stages x embedding_dims 16 of the tiny autoencoder
WAV_TOL = 1e-4
CODE_SHARE = 0.01
SITE_WAV_REL = 2e-2
TASK_REL = 5e-2
INT8_BOUND = 0.25  # int8 against the float decoder, the JAX package's bound for the task


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _jax(fn):
    with jax.default_matmul_precision("highest"):
        return fn()


# ---------------------------------------------------------------- legacy TTS


class JStandInAM(nn.Module):
    in_dim: int = MEL_DIM
    out_dim: int = AM_DIM

    @nn.compact
    def __call__(self, mel, mel_length, deterministic: bool = True):
        return {"mel": nn.Dense(self.out_dim, name="proj")(mel), "mel_length": mel_length}


class TStandInAM(torch.nn.Module):
    def __init__(self, in_dim: int = MEL_DIM, out_dim: int = AM_DIM):
        super().__init__()
        self.proj = Linear(in_dim, out_dim)

    def forward(self, mel, mel_length):
        return {"mel": self.proj(mel), "mel_length": mel_length}


@pytest.fixture(scope="module")
def stand_in():
    """The stand-in acoustic model in both registries, with its weight
    mapping in the port's task layer."""
    if AM_NAME not in j_registry.NETWORKS:
        j_registry.register_network(AM_NAME)(JStandInAM)
    if AM_NAME not in t_registry.NETWORKS:
        t_registry.register_network(AM_NAME)(TStandInAM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(t_tasks._FROM_JAX, AM_NAME,
                   lambda state, name, module: W.dense_from_jax(state["params"][name]["proj"], "proj"))
        yield


VOCODER = {"_name": "HifiGANGenerator", "num_mels": AM_DIM, "resblock_kernel_sizes": [3],
           "resblock_dilation_sizes": [[1, 3]], "upsample_rates": [2, 2], "upsample_initial_channel": 16,
           "upsample_kernel_sizes": [4, 4]}


def _tts_config(ending: str, tmpdir: str) -> dict:
    task = {"_name": "TTS", "acoustic_model": {"_name": AM_NAME, "in_dim": MEL_DIM, "out_dim": AM_DIM}}
    if ending == "autoencoder":
        task["autoencoder"] = tiny_ae_config(tmpdir).to_dict()["task"]["autoencoder"]
    elif ending == "vocoder":
        task["vocoder"] = dict(VOCODER)
    return {
        "task": task,
        "dataset": {"_name": "MelDataset", "samplerate": 1600, "feature": ["mel"],
                    "feature_path": [f"{tmpdir}/mel/{{}}.npy"], "dimension": [MEL_DIM], "frameshift": [FRAMESHIFT],
                    "padding_value": [-4], "segment_length": -1, "id_list": None},
        "save_features": [["wav", ".npy"], ["mel", ".npy"]],
    }


def _gains(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _gains(v, rng)
        elif k == "g":
            tree[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
    return tree


def _init_state(config: dict, rng) -> dict:
    """Every network of the task initialised in JAX: a checkpoint state."""
    mel = np.zeros((1, 8, MEL_DIM), np.float32)
    length = np.array([8], np.int32)
    key = jax.random.PRNGKey(0)
    state = {"params": {}}
    for name, node in config["task"].items():
        if name.startswith("_"):
            continue
        module = get_network(node["_name"])(**{k: v for k, v in node.items() if not k.startswith("_")})
        if name == "autoencoder":
            v = jax.device_get(jax.jit(lambda k: module.init({"params": k, "dropout": k}, mel, length))(key))
            state["codebook"] = v["codebook"]
        elif name == "vocoder":
            v = jax.device_get(jax.jit(lambda k: module.init(k, np.zeros((1, 8, AM_DIM), np.float32)))(key))
        else:
            v = jax.device_get(jax.jit(lambda k: module.init(k, mel, length))(key))
        state["params"][name] = _gains(jax.tree_util.tree_map(np.asarray, v["params"]), rng)
    return state


def _tasks(config: dict, state: dict):
    jtask = build_task(Config(config), mode="infer")
    jtask.load_variables(state)
    ttask = t_build_task(TConfig(config), device="cpu")
    ttask.load_variables(state)
    return jtask, ttask


def _jax_autoencoder_ending(jtask, batch):
    """What the JAX task's autoencoder ending computes
    (``msmctts_tpu/tasks.py:150-183``), with the stages' scales read from
    the autoencoder's config: that code reads ``ae.encoder.downsample_scales``
    outside ``apply``, where flax has not built the submodule, and raises."""
    am, ae = jtask.networks["acoustic_model"], jtask.networks["autoencoder"]
    scales = list(ae.encoder_config["downsample_scales"])
    am_out = am.apply(jtask.variables["acoustic_model"], **batch)
    mel, mel_length = am_out["mel"], np.asarray(batch["mel_length"])

    @jax.jit
    def fn(v, mel, mel_length):
        chunks = jax.numpy.split(mel, len(scales), axis=-1)
        preds, lengths, cum = [], [], 1
        for scale, c in zip(scales, chunks):
            cum *= scale
            if cum > 1:
                B, T, C = c.shape
                c = jax.numpy.mean(c.reshape(B, T // cum, cum, C), axis=2)
            preds.append(c)
            lengths.append(jax.numpy.ceil(mel_length / cum).astype(jax.numpy.int32))
        return ae.apply(v, preds[::-1], lengths[::-1], method="synthesis")

    wav = np.asarray(fn(jtask.variables["autoencoder"], mel, mel_length))
    ratio = wav.shape[1] // mel.shape[1]
    return {"mel_length": np.asarray(am_out["mel_length"]),
            "wav": [w[: int(n) * ratio, 0] for w, n in zip(wav, am_out["mel_length"])]}


@pytest.mark.parametrize("ending", ["autoencoder", "vocoder", "mel"])
def test_legacy_tts_infer_step_matches_jax(stand_in, tmp_path, ending):
    rng = np.random.default_rng(3)
    config = _tts_config(ending, str(tmp_path))
    jtask, ttask = _tasks(config, _init_state(config, rng))
    assert sorted(ttask.networks) == sorted(jtask.networks) and not any(m.training for m in ttask.networks.values())
    batch = {"mel": rng.normal(size=(3, 16, MEL_DIM)).astype(np.float32), "mel_length": np.array([16, 11, 6])}
    if ending == "autoencoder":
        with pytest.raises(AttributeError, match="encoder"):  # a fault of the JAX task, not repaired there
            jtask.infer_step(batch)
        want = _jax(lambda: _jax_autoencoder_ending(jtask, batch))
    else:
        want = _jax(lambda: jtask.infer_step(batch))
    got = ttask.infer_step(batch)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["mel_length"], np.asarray(want["mel_length"]))
    key = "mel" if ending == "mel" else "wav"
    ratio = 1 if ending == "mel" else FRAMESHIFT
    for g, w, n in zip(got[key], want[key], batch["mel_length"]):
        assert g.shape == np.asarray(w).shape and g.shape[0] == n * ratio
        np.testing.assert_allclose(g, np.asarray(w), atol=WAV_TOL, rtol=0)
    if ending != "mel":
        assert max(float(np.abs(w).max()) for w in got["wav"]) > 1e-3


def test_legacy_tts_through_the_infer_cli_matches_jax(stand_in, tmp_path):
    """``python -m msmctts_tpu_torch.infer`` over a checkpoint of the task
    (its vocoder ending) and a test list of mel files: each saved wav
    against the JAX task's ``infer_step`` on the JAX loader's batch."""
    rng = np.random.default_rng(4)
    d = str(tmp_path)
    config = _tts_config("vocoder", d)
    os.makedirs(f"{d}/mel")
    lines = {}
    for i, n in enumerate((16, 12, 10)):
        np.save(f"{d}/mel/u{i}.npy", rng.normal(size=(n, MEL_DIM)).astype(np.float32))
        lines[f"u{i}"] = {"mel": f"{d}/mel/u{i}.npy"}
    test_list = f"{d}/test.yaml"
    with open(test_list, "w") as f:
        yaml.safe_dump(lines, f)
    state = _init_state(config, rng)
    ckpt = f"{d}/tts.ckpt"
    save_checkpoint(ckpt, state, 1, config)
    out_dir = f"{d}/out"
    t_infer.main(["-m", ckpt, "-t", test_list, "-o", out_dir, "--device", "cpu"])

    jtask = build_task(Config(config), mode="infer")
    jtask.load_variables(load_checkpoint(ckpt)["state"])
    jconfig = Config(config)
    dataset = j_build_dataset(jconfig, training=False, id_list=test_list)
    seen = 0
    for batch in j_finite_loader(dataset, 1):
        name = dataset.id_list[int(batch.pop("_id")[0])][0]
        want = np.asarray(_jax(lambda: jtask.infer_step(batch))["wav"][0])
        got = np.load(os.path.join(out_dir, f"{name}_wav.npy"))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=WAV_TOL, rtol=0)
        seen += 1
    assert seen == len(lines)


# ------------------------------------------------------------ int8 under bf16


def _record(cls, log):
    """Wrap ``cls.__call__`` (an ``_ActQuant``) to log each site's codes."""
    call = cls.__call__

    def recording(self, x, site, s_in=None):
        q, s = call(self, x, site, s_in)
        if self.scales is not None:
            log[site] = np.asarray(q)
        return q, s

    return recording


def test_bf16_int8_decoder_codes_follow_jax_site_by_site(tiny_pair, monkeypatch):
    """Both bf16 int8 decoders, built over the same bf16-rounded decoder and
    calibrated on the same features, quantize the same input: per site the
    codes agree but for rounding-boundary flips of one step; the float sites
    and the output are bf16 in both."""
    rng = np.random.default_rng(6)
    ck = load_checkpoint(tiny_pair["ae"])
    config = Config(ck["config"])
    config["precision"] = "bfloat16"
    jtask = build_task(config, mode="infer")
    jtask.load_variables(ck["state"])
    tconfig = TConfig(t_load_checkpoint(tiny_pair["ae"])["config"])
    tconfig["precision"] = "bfloat16"
    ttask = t_build_task(tconfig, device="cpu")
    ttask.load_variables(t_load_checkpoint(tiny_pair["ae"])["state"])
    jtask.int8_decoder = ttask.int8_decoder = True
    j8, t8 = jtask._int8(), ttask._int8()
    assert j8.dtype == jax.numpy.bfloat16 and t8.dtype == torch.bfloat16
    feats = rng.normal(size=(2, 24, 16)).astype(np.float32)
    _jax(lambda: j8.calibrate(jax.numpy.asarray(feats)))
    t8.calibrate(torch.as_tensor(feats))
    for site, s in j8.scales.items():
        assert t8.scales[site] == pytest.approx(s, rel=1e-6), site
    j_codes, t_codes = {}, {}
    monkeypatch.setattr(J._ActQuant, "__call__", _record(J._ActQuant, j_codes))
    monkeypatch.setattr(T._ActQuant, "__call__", _record(T._ActQuant, t_codes))
    want = _jax(lambda: J.int8_generator_apply(j8.qparams, jax.numpy.asarray(feats), j8.decoder_config,
                                               dtype=j8.dtype, act_scales=j8.scales))
    got = t8.apply(torch.as_tensor(feats))
    assert got.dtype == torch.bfloat16 and want.dtype == jax.numpy.bfloat16
    assert sorted(t_codes) == sorted(j_codes) and len(j_codes) == 11
    for site in j_codes:
        diff = np.abs(t_codes[site].astype(np.int32) - j_codes[site].astype(np.int32))
        assert diff.max() <= 1 and diff.mean() <= CODE_SHARE, (site, diff.mean())
    want = np.asarray(want, np.float32)
    assert _rel(got.float().numpy(), want) < SITE_WAV_REL


def test_bf16_int8_analysis_synthesis_and_predict_follow_jax(tiny_pair):
    """End to end through the bf16 tasks with ``int8_decoder``, each
    calibrated on its first batch: the waveforms against JAX's bf16 int8
    task, and int8 against the float bf16 decode within JAX's bound."""
    rng = np.random.default_rng(2)
    for path, batch in ((tiny_pair["ae"], {"mel": rng.normal(size=(2, 16, MEL_DIM)).astype(np.float32),
                                           "mel_length": np.array([16, 10])}),
                        (tiny_pair["am"], _batch(True))):
        ck = load_checkpoint(path)
        config = Config(ck["config"])
        config["precision"] = "bfloat16"
        jtask = build_task(config, mode="infer")
        jtask.load_variables(ck["state"])
        tconfig = TConfig(t_load_checkpoint(path)["config"])
        tconfig["precision"] = "bfloat16"
        ttask = t_build_task(tconfig, device="cpu")
        ttask.load_variables(t_load_checkpoint(path)["state"])
        float_wav = ttask.infer_step(batch)["wav"]
        jtask.int8_decoder = ttask.int8_decoder = True
        want = _jax(lambda: jtask.infer_step(batch))["wav"]
        got = ttask.infer_step(batch)["wav"]
        for g, w, f in zip(got, want, float_wav):
            w = np.asarray(w, np.float32)
            assert g.dtype == np.float32 and g.shape == w.shape
            assert _rel(g, w) < TASK_REL
            assert _rel(g, f) < INT8_BOUND
