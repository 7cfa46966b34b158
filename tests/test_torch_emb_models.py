"""The port's QS-TTS modules against msmctts_tpu, on the CPU, at the tiny
widths of ``tests/tiny.py::tiny_emb_config`` (12-dim embeddings, model
width 16, 2 stages, 2 heads, ECAPA, pitch / energy, prosody estimator),
with JAX-initialised weights carried over by ``msmctts_tpu_torch.weights``.

Tolerances (fp32, JAX under matmul precision "highest"): indices exact;
module outputs and waveforms 1e-4 (the earlier slices' module tolerance;
weight-norm gains and batch statistics perturbed so that outputs are O(1));
batch-norm running statistics 2e-5. Every train-mode comparison checks the
``batch_stats`` after one call: flax moves them with the biased batch
variance, ``torch.nn.BatchNorm1d`` with the unbiased one.
"""

import os

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from msmctts_tpu.config import Config as JConfig
from msmctts_tpu.config import component_kwargs
from msmctts_tpu.data.datasets import EmbDataset as JEmbDataset
from msmctts_tpu.data.datasets import TTSDataset as JTTSDataset
from msmctts_tpu.models import msmc_vqgan_emb as J
from msmctts_tpu.models import tdnn as JT
from msmctts_tpu.models.predictor import MultiStagePredictor
from msmctts_tpu.tasks import build_task
from msmctts_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.data import datasets as TD
from msmctts_tpu_torch.models import msmc_vqgan_emb as P
from msmctts_tpu_torch.models import tdnn as PT
from msmctts_tpu_torch.registry import get_network, get_task
from msmctts_tpu_torch.tasks import MSMCTTS
from msmctts_tpu_torch.tasks import build_task as t_build_task
from tests.tiny import FRAMESHIFT, MEL_DIM, tiny_am_config, tiny_emb_config, write_tiny_emb_dataset

torch.set_num_threads(2)

EMB = tiny_emb_config("/unused")
AE = EMB.task["autoencoder"]
TOL = 1e-4
STATS_TOL = 2e-5
B, T = 3, 16
LENGTHS = np.array([16, 12, 5])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _perturb(tree, rng):
    """Random weight-norm gains and BN running statistics (flax's init
    leaves them at |v|, 0 and 1), so that folded kernels and the eval-mode
    normalization are exercised with O(1) outputs."""
    def visit(node):
        for k, v in node.items():
            if isinstance(v, dict):
                visit(v)
            elif k == "g":
                node[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
            elif k == "mean":
                node[k] = rng.normal(size=v.shape).astype(np.float32) * 0.1
            elif k == "var":
                node[k] = rng.uniform(0.5, 2.0, size=v.shape).astype(np.float32)
    visit(tree)
    return tree


def _inputs(rng, Bx=B, Tx=T):
    lengths = LENGTHS if Bx == B and Tx == T else np.full(Bx, Tx)
    valid = (np.arange(Tx)[None] < lengths[:, None])[..., None]
    return dict(
        emb=(rng.normal(size=(Bx, Tx, 12)) * valid).astype(np.float32),
        emb_length=lengths.astype(np.int32),
        pitch=(rng.normal(size=(Bx, Tx, 1)) * valid).astype(np.float32),
        energy=(rng.normal(size=(Bx, Tx, 1)) * valid).astype(np.float32),
        mel=np.where(valid, rng.normal(size=(Bx, Tx, MEL_DIM)), -4.0).astype(np.float32),
    )


def _torch_inputs(inp):
    return {k: _t(v, torch.long if k == "emb_length" else torch.float32) for k, v in inp.items()}


# ------------------------------------------------------------------ TDNN


def _flax_bn_case(rng, shape):
    x = rng.normal(size=shape).astype(np.float32) * 2.0 + 0.5
    mod = fnn.BatchNorm(momentum=JT.BN_MOMENTUM)
    v = _np_tree(mod.init(jax.random.PRNGKey(0), x, use_running_average=True))
    v["params"]["scale"] = rng.uniform(0.5, 1.5, size=shape[-1]).astype(np.float32)
    v["params"]["bias"] = rng.normal(size=shape[-1]).astype(np.float32)
    v = {"params": v["params"], "batch_stats": _perturb(v["batch_stats"], rng)}
    port = PT.BatchNorm(shape[-1])
    W.load_numpy_state(port, {k[1:]: a for k, a in W.batch_norm_from_jax(v["params"], v["batch_stats"], "").items()})
    return x, mod, v, port


@pytest.mark.parametrize("shape", [(4, 9, 6), (5, 6)], ids=["frames", "vectors"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batch_norm_matches_flax(rng, shape, train):
    x, mod, v, port = _flax_bn_case(rng, shape)
    with jax.default_matmul_precision("highest"):
        want, mut = mod.apply(v, x, use_running_average=not train, mutable=["batch_stats"])
    got = port.train(train)(_t(x))
    _close(got.detach(), want)
    new_stats = mut["batch_stats"] if train else v["batch_stats"]
    _close(port.running_mean, new_stats["mean"], STATS_TOL)
    _close(port.running_var, new_stats["var"], STATS_TOL)
    if train:  # the trap: torch's own BatchNorm1d moves the variance by the unbiased estimate
        ref = torch.nn.BatchNorm1d(shape[-1], momentum=1 - JT.BN_MOMENTUM)
        ref.running_var.copy_(_t(v["batch_stats"]["var"]))
        ref(_t(x).reshape(-1, shape[-1]))
        assert not np.allclose(ref.running_var.numpy(), np.asarray(new_stats["var"]), rtol=STATS_TOL, atol=STATS_TOL)


def _tdnn_blocks():
    """(name, flax module, port module, JAX -> port mapping, input channels)."""
    C = 16
    return {
        "ConvReluBn": (JT.ConvReluBn(C, 5, 2, 4), PT.Conv1dReluBn(8, C, 5, 2, 4),
                       lambda p, s: W.conv_relu_bn_from_jax(p, s, "_"), 8),
        "Res2ConvReluBn": (JT.Res2ConvReluBn(C, 3, 2, 2, 8), PT.Res2Conv1dReluBn(C, 3, 2, 2, 8),
                           lambda p, s: W.res2_conv_relu_bn_from_jax(p, s, "_"), C),
        "SEConnect": (JT.SEConnect(C), PT.SE_Connect(C), lambda p, s: W.se_connect_from_jax(p, "_"), C),
        "SERes2Block": (JT.SERes2Block(C, 3, 3, 3, 8), PT.SE_Res2Block(C, 3, 3, 3, 8),
                        lambda p, s: W.se_res2_block_from_jax(p, s, "_"), C),
        "AttentiveStatsPool": (JT.AttentiveStatsPool(128), PT.AttentiveStatsPool(C, 128),
                               lambda p, s: W.attentive_stats_pool_from_jax(p, "_"), C),
    }


def _apply_block(mod, v, x, train):
    has_bn = "batch_stats" in v
    kwargs = {} if isinstance(mod, (JT.SEConnect, JT.AttentiveStatsPool)) else {"train": train}
    if has_bn:
        return mod.apply(v, x, mutable=["batch_stats"], **kwargs)
    return mod.apply(v, x, **kwargs), {}


@pytest.mark.parametrize("name", list(_tdnn_blocks()))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_tdnn_block_matches_flax(rng, name, train):
    mod, port, mapping, c_in = _tdnn_blocks()[name]
    x = rng.normal(size=(3, 20, c_in)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        v = _np_tree(mod.init(jax.random.PRNGKey(1), x))
        if "batch_stats" in v:
            v["batch_stats"] = _perturb(v["batch_stats"], rng)
        want, mut = _apply_block(mod, v, x, train)
    sd = mapping(v["params"], v.get("batch_stats"))
    W.load_numpy_state(port, {k[2:]: a for k, a in sd.items()})
    port.train(train)
    accepts_train = not isinstance(port, (PT.SE_Connect, PT.AttentiveStatsPool))
    got = port(_t(x), train) if accepts_train else port(_t(x))
    _close(got.detach(), want)
    if "batch_stats" in v:  # the running statistics after the call (moved in train mode only)
        stats = _np_tree(mut["batch_stats"])
        for k, a in W.state_dict_numpy(port).items():
            if k.endswith(("running_mean", "running_var")):
                want_stat = _lookup(stats, _bn_stats_path(name, k.rsplit(".", 1)[0]))
                _close(a, want_stat["mean" if k.endswith("mean") else "var"], STATS_TOL)


def _bn_stats_path(block, bn):
    """The flax ``batch_stats`` path of a port BN module name of a block."""
    parts = bn.split(".")
    if block == "ConvReluBn":
        return ["BatchNorm_0"]
    if block == "Res2ConvReluBn":
        return [f"bn_{parts[1]}"]
    sub = {"0": "in", "1": "res2", "2": "out"}[parts[0]]
    return [sub, "BatchNorm_0"] if parts[0] != "1" else [sub, f"bn_{parts[2]}"]


def _lookup(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _ecapa_case(rng):
    x = np.where(rng.uniform(size=(B, T, 1)) < 0.8, rng.normal(size=(B, T, MEL_DIM)), -4.0).astype(np.float32)
    mod = JT.ECAPA_TDNN(in_channels=MEL_DIM, embd_dim=16, channels=16)
    with jax.default_matmul_precision("highest"):
        v = _np_tree(mod.init(jax.random.PRNGKey(2), x))
    v["batch_stats"] = _perturb(v["batch_stats"], rng)
    port = PT.ECAPA_TDNN(MEL_DIM, 16, 16)
    W.load_numpy_state(port, W.ecapa_tdnn_from_jax(v["params"], v["batch_stats"]))
    return x, mod, v, port


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_ecapa_tdnn_matches_flax(rng, train):
    x, mod, v, port = _ecapa_case(rng)
    with jax.default_matmul_precision("highest"):
        want, mut = mod.apply(v, x, train=train, mutable=["batch_stats"])
    got = port.train(train)(_t(x))
    _close(got.detach(), want)
    stats = W.ecapa_tdnn_to_jax(W.state_dict_numpy(port))[1]
    want_stats = _np_tree(mut["batch_stats"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(want_stats):
        _close(_lookup(stats, [p.key for p in path]), leaf, STATS_TOL)
    if train:
        before = jax.tree_util.tree_leaves(v["batch_stats"])
        assert all(not np.allclose(a, b) for a, b in zip(before, jax.tree_util.tree_leaves(want_stats)))


def test_ecapa_manipulate_matches_flax(rng):
    x, mod, v, port = _ecapa_case(rng)
    x2 = rng.normal(size=x.shape).astype(np.float32)
    alpha = np.array([[0.3, 0.7], [0.5, 0.5], [1.0, 0.0]], np.float32)
    with jax.default_matmul_precision("highest"):
        want = mod.apply(v, [x, x2], alpha, method="manipulate")
    got = port.eval().manipulate([_t(x), _t(x2)], _t(alpha))
    _close(got.detach(), want)


def test_xvector_tdnn_matches_flax_in_eval(rng):
    x = rng.normal(size=(2, 60, MEL_DIM)).astype(np.float32)
    mod = JT.XVectorTDNN(MEL_DIM, 5)
    with jax.default_matmul_precision("highest"):
        v = _np_tree(mod.init(jax.random.PRNGKey(3), x))
        v["batch_stats"] = _perturb(v["batch_stats"], rng)
        want = mod.apply(v, x)
    port = PT.XVectorTDNN(MEL_DIM, 5)
    W.load_numpy_state(port, W.xvector_tdnn_from_jax(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = port.eval()(_t(x))
    _close(got, want)


# -------------------------------------------------------------- encoders


@pytest.mark.parametrize("pitch", [True, False], ids=["pitch", "no-pitch"])
def test_mams_encoder_matches_flax(rng, pitch):
    inp = _inputs(rng)
    x = rng.normal(size=(B, T, 16)).astype(np.float32)
    cfg = dict(AE["encoder_config"])
    mod = J.MAMSEncoder(in_channels=16, pitch_dim=int(pitch), energy_dim=int(pitch), **cfg)
    args = (inp["pitch"], inp["energy"]) if pitch else (None, None)
    with jax.default_matmul_precision("highest"):
        v = _np_tree(mod.init(jax.random.PRNGKey(4), x, inp["emb_length"], *args))
        (want, want_content) = mod.apply(v, x, inp["emb_length"], *args)
    port = P.MAMSEncoder(16, int(pitch), int(pitch), **cfg).eval()
    W.load_numpy_state(port, W.mams_encoder_from_jax(v["params"]))
    assert (port.pitch_encoder is not None) == pitch
    with torch.no_grad():
        got, content = port(_t(x), _t(inp["emb_length"], torch.long),
                            *(_t(a) if a is not None else None for a in args))
    assert len(got) == len(want) == 2
    for (g, gl), (w, wl) in zip(got, want):
        _close(g, w)
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    _close(content, want_content)  # stage 0 before the pitch encoding
    if pitch:
        assert not np.allclose(content.numpy(), got[0][0].numpy())


# ---------------------------------------------------------- autoencoders


def _port_kwargs(node):
    return {k: (dict(v) if isinstance(v, dict) else v) for k, v in component_kwargs(node).items()}


@pytest.fixture(scope="module")
def emb_model():
    """The tiny MSMCVQGANEmb initialised in JAX (gains and statistics
    perturbed) and the port's copy of it."""
    rng = np.random.default_rng(5)
    inp = _inputs(rng)
    mod = J.MSMCVQGANEmb(**component_kwargs(AE))
    with jax.default_matmul_precision("highest"):
        v = _np_tree(mod.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, **inp,
                              deterministic=False))
    v["params"] = _perturb(v["params"], rng)
    v["batch_stats"] = _perturb(v["batch_stats"], rng)
    port = get_network("MSMCVQGANEmb")(**_port_kwargs(AE))
    W.load_numpy_state(port, W.emb_autoencoder_from_jax(v))
    return mod, v, port.eval()


def test_emb_forward_matches_flax_in_eval(emb_model, rng):
    mod, v, port = emb_model
    inp = _inputs(rng)
    with jax.default_matmul_precision("highest"):
        want = mod.apply(v, **inp, deterministic=True)
    with torch.no_grad():
        got = port(**_torch_inputs(inp))
    assert got["decoder_outputs"].shape == (B, T * FRAMESHIFT, 1)
    assert float(got["decoder_outputs"].abs().max()) > 1e-2  # not a silent decoder
    _close(got["decoder_outputs"], want["decoder_outputs"])
    _close(got["mel_outputs"], want["mel_outputs"])
    _close(got["content_representations"], want["content_representations"])
    for a, b in zip(got["encoder_indices"], want["encoder_indices"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got["decoder_diffs"] is None


def test_emb_forward_matches_flax_in_train_mode(emb_model, rng):
    """One training forward without dropout: outputs, prior losses, and the
    mutated codebook and BN statistics."""
    mod, v, _ = emb_model
    cfg = dict(AE)
    cfg["encoder_config"] = dict(cfg["encoder_config"], dropout=0.0, attn_dropout=0.0)
    cfg["quantizer_config"] = dict(cfg["quantizer_config"], dropout=0.0,
                                   prior_config=dict(cfg["quantizer_config"]["prior_config"], p_dropout=0.0))
    jmod = J.MSMCVQGANEmb(**component_kwargs(JConfig({"n": cfg})["n"]))
    inp = _inputs(rng)
    with jax.default_matmul_precision("highest"):
        want, mut = jmod.apply(v, **inp, deterministic=False, mutable=["codebook", "batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(3)})
    port = get_network("MSMCVQGANEmb")(**_port_kwargs(cfg))
    W.load_numpy_state(port, W.emb_autoencoder_from_jax(v))
    port.train()
    got = port(**_torch_inputs(inp))
    _close(got["decoder_outputs"].detach(), want["decoder_outputs"])
    _close(got["mel_outputs"].detach(), want["mel_outputs"])
    for a, b in zip(got["encoder_indices"], want["encoder_indices"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in want["decoder_diffs"]:
        _close(got["decoder_diffs"][k].detach(), want["decoder_diffs"][k])
    state = W.emb_autoencoder_to_jax(W.state_dict_numpy(port))
    for key in ("codebook", "batch_stats"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(_np_tree(mut[key])):
            np.testing.assert_allclose(_lookup(state[key], [p.key for p in path]), leaf, rtol=STATS_TOL,
                                       atol=STATS_TOL, err_msg=str(path))


def test_emb_analysis_and_synthesis_match_flax(emb_model, rng):
    mod, v, port = emb_model
    inp = _inputs(rng)
    with jax.default_matmul_precision("highest"):
        q = mod.apply(v, inp["emb"], inp["emb_length"], inp["pitch"], inp["energy"], method="analysis",
                      deterministic=True)
        want = mod.apply(v, q["quantizer_outputs"], q["quantizer_lengths"], ref=inp["mel"], method="synthesis",
                         deterministic=True)
        want_plain = mod.apply(v, q["quantizer_outputs"], q["quantizer_lengths"], method="synthesis",
                               deterministic=True)
    ti = _torch_inputs(inp)
    with torch.no_grad():
        tq = port.analysis(ti["emb"], ti["emb_length"], ti["pitch"], ti["energy"])
        for a, b in zip(tq["quantizer_indices"], q["quantizer_indices"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tq["quantizer_outputs"], q["quantizer_outputs"]):
            _close(a, b)
        got = port.synthesis(tq["quantizer_outputs"], tq["quantizer_lengths"], ref=ti["mel"])
        got_plain = port.synthesis(tq["quantizer_outputs"], tq["quantizer_lengths"])
    _close(got, want)
    _close(got_plain, want_plain)


def test_emb_windowed_decode_with_sub_batch_matches_flax(emb_model, rng):
    """(i, s) windows: row 1 gives two windows, row 0 none, a start past the
    end is clamped as ``dynamic_slice`` clamps it."""
    mod, v, port = emb_model
    inp = _inputs(rng)
    idx, starts, frames = np.array([1, 1, 2, 2]), np.array([0, 5, 14, 3]), 6
    with jax.default_matmul_precision("highest"):
        want = mod.apply(v, **inp, window_indices=idx, window_starts=starts, window_frames=frames, deterministic=True)
    with torch.no_grad():
        got = port(**_torch_inputs(inp), window_indices=_t(idx), window_starts=_t(starts), window_frames=frames)
    assert got["decoder_outputs"].shape == (4, frames * FRAMESHIFT, 1)  # 4 windows from a batch of 3
    _close(got["decoder_outputs"], want["decoder_outputs"])
    assert not torch.allclose(got["decoder_outputs"][0], got["decoder_outputs"][1])


def test_kmeans_vqgan_emb_matches_flax(rng, tmp_path):
    centroids = rng.normal(size=(8, 12)).astype(np.float32)
    path = str(tmp_path / "kmeans.npy")
    np.save(path, centroids)
    kw = dict(emb_dim=12, n_model_size=16, quantizer_path=path, decoder_config=dict(AE["decoder_config"]),
              pred_mel=True, mel_dim=MEL_DIM)
    mod = J.KMeansVQGANEmb(**kw)
    inp = _inputs(rng)
    with jax.default_matmul_precision("highest"):
        v = _np_tree(mod.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, inp["emb"],
                              inp["emb_length"]))
        v["params"] = _perturb(v["params"], rng)
        want = mod.apply(v, inp["emb"], inp["emb_length"], deterministic=True)
        q = mod.apply(v, inp["emb"], inp["emb_length"], method="analysis")
        want_syn = mod.apply(v, q["quantizer_outputs"], q["quantizer_lengths"], method="synthesis")
    port = get_network("KMeansVQGANEmb")(**kw)
    assert torch.equal(port.quantizer.embed, _t(centroids.T[None]))  # loaded from the .npy at build time
    W.load_numpy_state(port, W.emb_autoencoder_from_jax(v))
    port.eval()
    ti = _torch_inputs(inp)
    with torch.no_grad():
        got = port(ti["emb"], ti["emb_length"])
        tq = port.analysis(ti["emb"], ti["emb_length"])
        got_syn = port.synthesis(tq["quantizer_outputs"], tq["quantizer_lengths"])
    idx = got["encoder_indices"][0].numpy()
    np.testing.assert_array_equal(idx, np.asarray(want["encoder_indices"][0]))
    d = ((inp["emb"][:, :, None, :] - centroids[None, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(idx, d.argmin(-1))  # the true nearest centroid
    _close(got["decoder_outputs"], want["decoder_outputs"])
    _close(got_syn, want_syn)
    # the frozen codebook is not touched by the seeded init
    W.init_random(port, 7)
    assert torch.equal(port.quantizer.embed, _t(centroids.T[None]))


class _Fitted:
    """What a fitted sklearn KMeans keeps of its centroids."""

    cluster_centers_ = np.arange(24, dtype=np.float64).reshape(4, 6)


def test_kmeans_centroids_load_from_a_pickle(tmp_path):
    import pickle

    path = str(tmp_path / "kmeans.pkl")
    with open(path, "wb") as f:
        pickle.dump(_Fitted(), f)
    got = P.load_kmeans_centroids(path)
    assert got.dtype == np.float32 and got.shape == (4, 6)
    np.testing.assert_array_equal(got, J.load_kmeans_centroids(path))


def test_emb_vc_matches_flax(rng):
    kw = dict(emb_dim=12, n_model_size=16, encoder_config=dict(AE["encoder_config"]),
              global_encoder_config={"_name": "ECAPA_TDNN"}, decoder_config=dict(AE["decoder_config"]),
              mel_dim=MEL_DIM)
    mod = J.EmbVC(**kw)
    inp = _inputs(rng)
    with jax.default_matmul_precision("highest"):
        v = _np_tree(mod.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, **inp,
                              deterministic=False))
        v["params"] = _perturb(v["params"], rng)
        v["batch_stats"] = _perturb(v["batch_stats"], rng)
        want = mod.apply(v, **inp, deterministic=True)
    port = get_network("EmbVC")(**kw)
    W.load_numpy_state(port, W.emb_autoencoder_from_jax(v))
    with torch.no_grad():
        got = port.eval()(**_torch_inputs(inp))
    assert got["decoder_outputs"].shape == (B, T // 2 * FRAMESHIFT, 1)  # the coarsest stage decodes
    assert "encoder_indices" not in got
    _close(got["decoder_outputs"], want["decoder_outputs"])


def test_attr_predictor_matches_flax(rng):
    node = EMB.task["prosody_estimator"]
    x = rng.normal(size=(B, T, 16)).astype(np.float32)
    mod = J.AttrPredictor(**component_kwargs(node))
    with jax.default_matmul_precision("highest"):
        v = _perturb(_np_tree(mod.init(jax.random.PRNGKey(6), x, LENGTHS)), rng)
        want_h, want_o = mod.apply(v, x, LENGTHS, deterministic=True)
    port = get_network("AttrPredictor")(**component_kwargs(node))
    W.load_numpy_state(port, W.attr_predictor_from_jax(v["params"]))
    got_h, got_o = port.train()(_t(x), _t(LENGTHS, torch.long))  # no dropout even in train mode, as JAX runs it
    _close(got_h.detach(), want_h)
    _close(got_o.detach(), want_o)
    assert float(got_o[2, 5:].abs().max()) == 0.0  # masked past the length
    assert W.attr_predictor_to_jax(W.state_dict_numpy(port)).keys() == v["params"].keys()


@pytest.mark.parametrize("network", ["MSMCVQGANEmb", "EmbVC", "AttrPredictor"])
def test_weight_round_trip(emb_model, rng, network):
    if network == "MSMCVQGANEmb":
        want = emb_model[1]
        got = W.emb_autoencoder_to_jax(W.state_dict_numpy(emb_model[2]))
    elif network == "EmbVC":
        port = get_network("EmbVC")(emb_dim=12, n_model_size=16, encoder_config=dict(AE["encoder_config"]),
                                     global_encoder_config={"_name": "ECAPA_TDNN"},
                                     decoder_config=dict(AE["decoder_config"]), mel_dim=MEL_DIM, pred_mel=True)
        W.init_random(port, 3)
        want = W.emb_autoencoder_to_jax(W.state_dict_numpy(port))
        again = get_network("EmbVC")(emb_dim=12, n_model_size=16, encoder_config=dict(AE["encoder_config"]),
                                      global_encoder_config={"_name": "ECAPA_TDNN"},
                                      decoder_config=dict(AE["decoder_config"]), mel_dim=MEL_DIM, pred_mel=True)
        W.load_numpy_state(again, W.emb_autoencoder_from_jax(want))
        got = W.emb_autoencoder_to_jax(W.state_dict_numpy(again))
    else:
        port = get_network("AttrPredictor")(**component_kwargs(EMB.task["prosody_estimator"]))
        W.init_random(port, 4)
        want = {"params": W.attr_predictor_to_jax(W.state_dict_numpy(port))}
        again = get_network("AttrPredictor")(**component_kwargs(EMB.task["prosody_estimator"]))
        W.load_numpy_state(again, W.attr_predictor_from_jax(want["params"]))
        got = {"params": W.attr_predictor_to_jax(W.state_dict_numpy(again))}
    leaves = lambda t: {jax.tree_util.keystr(p): np.asarray(l) for p, l in jax.tree_util.tree_leaves_with_path(t)}
    g, w = leaves({k: got[k] for k in want}), leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ------------------------------------------------------------- datasets


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_emb_models_corpus"))
    write_tiny_emb_dataset(d, n_utts=6)
    return d


def test_emb_dataset_collate_matches_jax(corpus):
    node = dict(tiny_emb_config(corpus).dataset)
    node.pop("_name")
    jd = JEmbDataset(**node)
    td = TD.EmbDataset(**node)
    for idx in ([0, 1, 2, 3], [4, 5]):
        a = jd.collate_fn([jd[i] for i in idx])
        b = td.collate_fn([td[i] for i in idx])
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        T_b = b["emb"].shape[1]
        assert T_b % 64 == 0 and b["mel"].shape[1] == b["pitch"].shape[1] == T_b
        assert b["wav"].shape[1] == T_b * FRAMESHIFT
        np.testing.assert_array_equal(b["wav_length"], b["emb_length"] * FRAMESHIFT)


def test_tts_dataset_emb_branch_matches_jax(corpus):
    """The predictor recipe's feature list ``[text, dur, emb]``."""
    node = dict(tiny_am_config(corpus, "/unused").dataset)
    node.pop("_name")
    node.update(feature=["text", "dur", "emb"], dimension=[2, 1, 12], padding_value=[0, 0, 0],
                frameshift=[None, None, FRAMESHIFT],
                feature_path=[f"{corpus}/phone.txt", f"{corpus}/dur.txt", f"{corpus}/emb/{{}}.npy"])
    a = JTTSDataset(**node)
    b = TD.TTSDataset(**node)
    ja, tb = a.collate_fn([a[i] for i in range(4)]), b.collate_fn([b[i] for i in range(4)])
    assert sorted(ja) == sorted(tb) and "emb_length" in tb and "mel" not in tb
    for k in ja:
        np.testing.assert_array_equal(ja[k], tb[k], err_msg=k)
    np.testing.assert_array_equal(tb["dur"].sum(axis=1), tb["emb_length"])


# ----------------------------------------------------------- task layer


def test_qs_tts_names_resolve_to_the_ported_classes():
    assert get_task("NASynTTSEmb") is MSMCTTS and get_task("NASynTTSv2") is MSMCTTS
    assert get_network("NASynCascadeFastSpeech") is get_network("MultiStagePredictor")
    from msmctts_tpu_torch.registry import get_dataset, get_trainer

    assert get_dataset("EmbDataset") is TD.EmbDataset
    assert get_trainer("EmbVQGANTrainer").__name__ == "EmbVQGANTrainer"
    assert get_trainer("NASynEmbFSTrainer").__name__ == "NASynEmbFSTrainer"


def test_three_stream_predictor_of_the_qs_tts_recipe_matches_flax(rng):
    """``n_symbols: [100, 10, 2]`` (phone, tone, erhua) maps onto the port's
    ``word_emb.{0,1,2}``; teacher-forced forward in eval mode."""
    node = dict(tiny_am_config("/unused", "/unused").task["predictor"])
    node.update(n_symbols=[100, 10, 2])
    kw = component_kwargs(node)
    Lt, F = 7, 16
    text = np.stack([rng.integers(1, 100, size=(2, Lt)), rng.integers(0, 10, size=(2, Lt)),
                     rng.integers(0, 2, size=(2, Lt))], axis=-1).astype(np.int32)
    text_length = np.array([7, 5], np.int32)
    dur = np.array([[2, 3, 2, 3, 2, 2, 2], [3, 3, 3, 3, 4, 0, 0]], np.float32)
    feat = [rng.normal(size=(2, F // 2, 16)).astype(np.float32), rng.normal(size=(2, F, 16)).astype(np.float32)]
    feat_length = [np.array([8, 8]), np.array([16, 16])]
    mod = MultiStagePredictor(**kw)
    with jax.default_matmul_precision("highest"):
        v = _np_tree(mod.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, text, text_length,
                              dur=dur, feat=feat, feat_length=feat_length, deterministic=False))
        want = mod.apply(v, text, text_length, dur=dur, feat=feat, feat_length=feat_length, deterministic=True)
    assert sorted(n for n in v["params"] if n.startswith("word_emb")) == ["word_emb_0", "word_emb_1", "word_emb_2"]
    port = get_network("NASynCascadeFastSpeech")(**_port_kwargs(node))
    sd = W.multi_stage_predictor_from_jax(v["params"])
    assert {k for k in sd if k.startswith("word_emb")} == {f"word_emb.{i}.weight" for i in range(3)}
    W.load_numpy_state(port, sd)
    with torch.no_grad():
        got = port.eval()(_t(text, torch.long), _t(text_length, torch.long), dur=_t(dur),
                          feat=[_t(f) for f in feat], feat_length=[_t(n, torch.long) for n in feat_length])
    for a, b in zip(got["feat"], want["feat"]):
        _close(a, b)


def _emb_checkpoint(emb_model, path):
    """The tiny synthesizer as a JAX trainer would save it."""
    v = emb_model[1]
    state = {"params": {"autoencoder": v["params"]}, "codebook": v["codebook"],
             "model_state": {"batch_stats": v["batch_stats"]}}
    j_save_checkpoint(path, state, 1, EMB.to_dict())
    return state


def test_analysis_synthesis_task_matches_jax_infer_step(emb_model, tmp_path):
    state = _emb_checkpoint(emb_model, str(tmp_path / "model_1"))
    rng = np.random.default_rng(9)
    lengths = np.array([64, 41, 23], np.int32)
    batch = {"emb": rng.normal(size=(3, 64, 12)).astype(np.float32), "emb_length": lengths,
             "pitch": rng.normal(size=(3, 64, 1)).astype(np.float32),
             "energy": rng.normal(size=(3, 64, 1)).astype(np.float32),
             "mel": rng.normal(size=(3, 64, MEL_DIM)).astype(np.float32),
             "wav": np.zeros((3, 64 * FRAMESHIFT), np.float32)}
    with jax.default_matmul_precision("highest"):
        jtask = build_task(EMB, mode="infer")
        jtask.load_variables(state)
        want = jtask.infer_step(batch)
    task = t_build_task(TConfig(EMB.to_dict()), device="cpu")
    task.load_variables(state)
    got = task.infer_step(batch)
    np.testing.assert_array_equal(got["mel_length"], lengths)
    for a, b, n in zip(got["wav"], want["wav"], lengths):
        assert a.shape == (int(n) * FRAMESHIFT,) and np.isfinite(a).all()
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)
    assert ("ae_emb", 64, ("pitch", "energy", "mel")) in task.shapes
    # without pitch and mel the global encoder has no reference: refused, as JAX's ECAPA cannot run on None
    with pytest.raises(ValueError, match="reference"):
        task.infer_step({k: batch[k] for k in ("emb", "emb_length")})


@pytest.fixture(scope="module")
def emb_tts(emb_model, tmp_path_factory):
    """A tiny predictor (JAX init, durations biased to ~2 frames) over the
    tiny synthesizer's checkpoint, in both packages' inference tasks."""
    d = str(tmp_path_factory.mktemp("emb_tts"))
    ckpt = os.path.join(d, "model_1")
    _emb_checkpoint(emb_model, ckpt)
    config = tiny_am_config(d, ckpt)
    config["task"]["_name"] = "NASynTTSv2"
    config["task"]["predictor"]["_name"] = "NASynCascadeFastSpeech"
    rng = np.random.default_rng(2)
    text = np.stack([rng.integers(1, 20, size=(2, 16)), rng.integers(0, 5, size=(2, 16))], axis=-1).astype(np.int32)
    text[1, 11:] = 0
    batch = {"text": text, "text_length": np.array([16, 11], np.int32)}
    pred = MultiStagePredictor(**component_kwargs(config.task["predictor"]))
    with jax.default_matmul_precision("highest"):
        pv = _np_tree(pred.init(jax.random.PRNGKey(0), text, batch["text_length"], max_frames=32))
    pv["params"]["upsampler"]["DurationPredictor_0"]["Dense_0"]["bias"] = np.array([2.2], np.float32)
    state = {"params": {"predictor": pv["params"]}}
    with jax.default_matmul_precision("highest"):
        jtask = build_task(config, mode="infer")
        jtask.load_variables(state)
    task = t_build_task(TConfig(config.to_dict()), device="cpu")
    task.load_variables(state)
    return jtask, task, batch


def test_predict_over_an_emb_autoencoder_matches_jax(emb_tts):
    """The JAX package's ``predict`` runs the SSL-embedding synthesizer's
    ``synthesis`` (no speaker reference); the port does the same."""
    jtask, task, batch = emb_tts
    with jax.default_matmul_precision("highest"):
        want = jtask.infer_step(batch)
    got = task.infer_step(batch)
    assert type(task.networks["autoencoder"]).__name__ == "MSMCVQGANEmb"  # loaded from the checkpoint
    np.testing.assert_array_equal(got["duration"], np.asarray(want["duration"]))
    np.testing.assert_array_equal(got["mel_length"], np.asarray(want["mel_length"]))
    for a, b in zip(got["embedding"], want["embedding"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b, n in zip(got["wav"], want["wav"], got["mel_length"]):
        assert a.shape == (int(n) * FRAMESHIFT,) and np.isfinite(a).all()
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)


def test_predict_stream_over_an_emb_autoencoder_fails_in_both_packages(emb_tts):
    """JAX's ``predict_stream`` calls ``synthesis_features``, which
    ``MSMCVQGANEmb`` lacks; the port refuses the same request."""
    jtask, task, batch = emb_tts
    with jax.default_matmul_precision("highest"):
        with pytest.raises(AttributeError, match="synthesis_features"):
            meta, chunks = jtask.predict_stream(batch, chunk_frames=16)
            next(iter(chunks))
    with pytest.raises(NotImplementedError, match="JAX package has no such path"):
        task.predict_stream(batch, chunk_frames=16)
