"""The port's serving slice against msmctts_tpu end to end, on the CPU:
text -> wav ``predict`` on a tiny AE + AM pair initialised in JAX and
written as checkpoints; the trained full-width fixture's
``analysis_synthesis``; and the ``synthesize`` entry point."""

import os

import jax
import numpy as np
import pytest
import torch

from msmctts_tpu.config import Config
from msmctts_tpu.models.predictor import MultiStagePredictor
from msmctts_tpu.models.quantizer import nearest_codes as j_nearest_codes
from msmctts_tpu.registry import get_network
from msmctts_tpu.tasks import build_task, load_frozen_autoencoder
from msmctts_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from msmctts_tpu_torch import synthesize as t_synthesize
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.models.quantizer import nearest_codes as t_nearest_codes
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.tasks import extract_codebooks as t_extract_codebooks
from msmctts_tpu_torch.tasks import load_frozen_autoencoder as t_load_frozen_autoencoder
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint as t_load_checkpoint
from tests.tiny import FRAMESHIFT, MEL_DIM, tiny_ae_config, tiny_am_config

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "csmsc_ae_r5.f16.ckpt")


def _gains(tree, rng):
    """Random weight-norm gains: the HiFi-GAN init (N(0, 0.01), g = |v|)
    would make a near-silent decoder and a vacuous wav comparison."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _gains(v, rng)
        elif k == "g":
            tree[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def tiny_pair(tmp_path_factory):
    """A tiny AE + AM initialised in JAX and saved as msmctts_tpu/v1
    checkpoints; the AM config points at the AE checkpoint."""
    d = str(tmp_path_factory.mktemp("tiny_pair"))
    rng = np.random.default_rng(0)
    ae_cfg = tiny_ae_config(d)
    node = ae_cfg.task["autoencoder"]
    ae = get_network(node["_name"])(**{k: v for k, v in node.items() if not k.startswith("_")})
    mel = np.zeros((1, 8, MEL_DIM), np.float32)
    key = jax.random.PRNGKey(0)
    # jitted: an eager flax init dispatches op by op and takes tens of seconds
    av = jax.device_get(jax.jit(lambda k: ae.init(
        {"params": k, "dropout": k}, mel, np.array([8], np.int32), deterministic=True
    ))(key))
    params = _gains(av["params"], rng)
    ae_path = os.path.join(d, "ae.ckpt")
    save_checkpoint(ae_path, {"params": {"autoencoder": params}, "codebook": av["codebook"]}, 1, ae_cfg.to_dict())

    am_cfg = tiny_am_config(d, ae_path)
    pnode = am_cfg.task["predictor"]
    pred = MultiStagePredictor(**{k: v for k, v in pnode.items() if not k.startswith("_")})
    text = np.ones((1, 8, 2), np.int32)
    pv = jax.jit(lambda k: pred.init(
        k, text, np.array([8], np.int32), dur=np.ones((1, 8), np.float32), max_frames=16
    ))(key)
    pparams = MultiStagePredictor.bias_durations(jax.device_get(pv)["params"], 3.0)
    am_path = os.path.join(d, "am.ckpt")
    save_checkpoint(am_path, {"params": {"predictor": pparams}}, 1, am_cfg.to_dict())
    return {"dir": d, "ae": ae_path, "am": am_path}


def _batch(forced: bool):
    rng = np.random.default_rng(1)
    B, Lt = 3, 16
    text_length = np.array([11, 6, 16])
    valid = np.arange(Lt)[None] < text_length[:, None]
    text = np.stack([rng.integers(1, 20, (B, Lt)), rng.integers(0, 5, (B, Lt))], -1) * valid[..., None]
    batch = {"text": text.astype(np.int32), "text_length": text_length.astype(np.int32)}
    if forced:
        batch["dur"] = (rng.integers(1, 6, (B, Lt)) * valid).astype(np.float32)
    return batch


def _stage_indices(feats, codebooks, nearest):
    """Codeword indices of snapped predictions [B, T, H*d] per stage."""
    out = []
    for f, cb in zip(feats, codebooks):
        f = np.asarray(f)
        B, T, D = f.shape
        H = cb.shape[0]
        idx = nearest(f.reshape(B, T, H, D // H), cb)[0]
        out.append(np.asarray(idx))
    return out


@pytest.mark.parametrize("forced", [True, False], ids=["forced-durations", "predicted-durations"])
def test_predict_matches_jax(tiny_pair, forced):
    batch = _batch(forced)
    with jax.default_matmul_precision("highest"):
        ck = load_checkpoint(tiny_pair["am"])
        jtask = build_task(Config(ck["config"]), mode="infer")
        jtask.load_variables(ck["state"])
        want = jtask.infer_step(batch)
        p1 = jtask._predict_phase1(batch)
        jout = jtask.networks["predictor"].apply(
            jtask.variables["predictor"], p1["text"], p1["text_length"],
            dur=p1["durations_dev"].astype(np.float32), max_frames=p1["max_frames"],
            codebooks=p1["codebooks"],
        )
        j_idx = _stage_indices(jout["feat"], [np.asarray(c) for c in p1["codebooks"]], j_nearest_codes)

    tck = t_load_checkpoint(tiny_pair["am"])
    ttask = t_build_task(TConfig(tck["config"]), device="cpu")
    ttask.load_variables(tck["state"])
    got = ttask.infer_step(batch)
    with torch.inference_mode():
        tp1 = ttask._predict_phase1(batch)
        cbs = t_extract_codebooks(ttask.networks["autoencoder"])
        tout = ttask.networks["predictor"](
            tp1["text"], tp1["text_length"], dur=tp1["durations"], max_frames=tp1["max_frames"], codebooks=cbs
        )
        t_idx = _stage_indices([f.numpy() for f in tout["feat"]], cbs, lambda x, e: t_nearest_codes(torch.as_tensor(x), e))

    assert tp1["max_frames"] == p1["max_frames"]
    np.testing.assert_array_equal(got["duration"], np.asarray(want["duration"]))
    np.testing.assert_array_equal(got["mel_length"], np.asarray(want["mel_length"]))
    assert int(np.asarray(want["mel_length"]).min()) > 0
    for a, b in zip(t_idx, j_idx):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["embedding"], want["embedding"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b, n in zip(got["wav"], want["wav"], got["mel_length"]):
        assert a.shape == (n * FRAMESHIFT,)
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)
    assert max(np.abs(np.asarray(w)).max() for w in want["wav"]) > 1e-2


def test_autoencoder_methods_match_jax(tiny_pair):
    """analysis, encode_features, synthesis_features and synthesis of the
    tiny AE, port vs JAX."""
    rng = np.random.default_rng(2)
    mel = rng.normal(size=(2, 16, MEL_DIM)).astype(np.float32)
    mel_length = np.array([16, 10], np.int32)
    ae, av, _ = load_frozen_autoencoder(tiny_pair["ae"])
    with jax.default_matmul_precision("highest"):
        q = ae.apply(av, mel, mel_length, method="analysis")
        feats = ae.apply(av, mel, mel_length, method="encode_features")
        stages = ([np.asarray(x) for x in q["quantizer_outputs"]], [np.asarray(x) for x in q["quantizer_lengths"]])
        syn_feats = ae.apply(av, *stages, method="synthesis_features")
        wav = ae.apply(av, *stages, method="synthesis")
    tae, _ = t_load_frozen_autoencoder(tiny_pair["ae"], device="cpu")
    with torch.inference_mode():
        tm, tl = torch.as_tensor(mel), torch.as_tensor(mel_length).long()
        tq = tae.analysis(tm, tl)
        t_feats = tae.encode_features(tm, tl)
        t_stages = ([torch.tensor(x) for x in stages[0]], [torch.tensor(x).long() for x in stages[1]])
        t_syn_feats = tae.synthesis_features(*t_stages)
        t_wav = tae.synthesis(*t_stages)
    for a, b in zip(tq["quantizer_indices"], q["quantizer_indices"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(t_feats.numpy(), np.asarray(feats), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_syn_feats.numpy(), np.asarray(syn_feats), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_wav.numpy(), np.asarray(wav), atol=1e-4, rtol=0)
    assert tae.frameshift_ratio == FRAMESHIFT and t_wav.shape == (2, 16 * FRAMESHIFT, 1)


@pytest.mark.skipif(not os.path.exists(FIXTURE), reason="trained fixture not present")
def test_fixture_analysis_synthesis_matches_jax():
    T = 64
    rng = np.random.default_rng(0)
    batch = {
        "mel": rng.normal(size=(1, T, 80)).astype(np.float32) * 0.5,
        "mel_length": np.array([T], np.int32),
    }
    with jax.default_matmul_precision("highest"):
        ck = load_checkpoint(FIXTURE)
        jtask = build_task(Config(ck["config"]), mode="infer")
        jtask.load_variables(ck["state"])
        want = jtask.analysis_synthesis(batch)
        ae, v = jtask.networks["autoencoder"], jtask.variables["autoencoder"]
        jq = jax.jit(lambda v, m, l: ae.apply(v, m, l, method="analysis"))(v, batch["mel"], batch["mel_length"])

    tck = t_load_checkpoint(FIXTURE)
    ttask = t_build_task(TConfig(tck["config"]), device="cpu")
    ttask.load_variables(tck["state"])
    got = ttask.analysis_synthesis(batch)
    with torch.inference_mode():
        tq = ttask.networks["autoencoder"].analysis(torch.as_tensor(batch["mel"]), torch.as_tensor(batch["mel_length"]))

    for a, b in zip(tq["quantizer_indices"], jq["quantizer_indices"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got["wav"][0].shape == (T * 300,)
    np.testing.assert_allclose(got["wav"][0], np.asarray(want["wav"][0]), atol=5e-4, rtol=0)


def test_synthesize_entry_point_on_cpu(tiny_pair):
    from scipy.io import wavfile

    out = os.path.join(tiny_pair["dir"], "syn.wav")
    wav = t_synthesize.main(["-m", tiny_pair["am"], "--text", "3_1 7_2 12_0 5_4 9_1", "-o", out, "--device", "cpu"])
    sr, data = wavfile.read(out)
    assert sr == 1600 and data.shape == wav.shape
    assert wav.size > 0 and wav.size % FRAMESHIFT == 0 and np.isfinite(wav).all()
