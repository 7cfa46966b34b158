"""The port's streaming decode (``msmctts_tpu_torch/streaming.py``) against
its own monolithic decode and against ``msmctts_tpu/streaming.py``, on the
CPU: the same seeded HiFi-GAN weights (initialised in JAX, gains perturbed
so the output is O(1), carried across by ``weights.py``) decoded in chunks
of 4, 8 and 13 frames in the tiny and the CSMSC geometry at narrow
channels."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmctts_tpu.config import Config
from msmctts_tpu.models.hifigan import HifiGANGenerator
from msmctts_tpu.models.hifigan import receptive_field_frames as j_receptive_field_frames
from msmctts_tpu.streaming import StreamingDecoder as JStreamingDecoder
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.models import hifigan as t_hifigan
from msmctts_tpu_torch.streaming import StreamingDecoder
from tests.tiny import tiny_ae_config

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = dict(
    upsample_rates=[2, 2],
    upsample_kernel_sizes=[4, 4],
    upsample_initial_channel=32,
    resblock_kernel_sizes=[3],
    resblock_dilation_sizes=[[1, 3]],
)
# the CSMSC recipe's geometry (rates and kernels set the receptive field;
# channels narrowed)
CSMSC_CFG = dict(
    upsample_rates=[6, 5, 5, 2],
    upsample_kernel_sizes=[12, 11, 11, 4],
    upsample_initial_channel=32,
    resblock_kernel_sizes=[3, 7, 11],
    resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
)
GEOMETRIES = {"tiny": TINY_CFG, "csmsc": CSMSC_CFG}
NUM_MELS = 8
# frames per geometry: several chunks of every size with a ragged tail
FRAMES = {"tiny": 57, "csmsc": 101}
SELF_TOL = 1e-6  # stream vs the port's own monolithic decode
JAX_TOL = 1e-5  # stream vs the JAX package's StreamingDecoder


def _gains(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _gains(v, rng)
        elif k == "g":
            tree[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
    return tree


_BUILT = {}


def _pair(geometry):
    """(flax module, params, port generator in eval()) on equal weights."""
    if geometry not in _BUILT:
        cfg = GEOMETRIES[geometry]
        g = HifiGANGenerator(num_mels=NUM_MELS, **cfg)
        params = jax.jit(g.init)(jax.random.PRNGKey(0), np.zeros((1, 16, NUM_MELS), np.float32))
        params = {"params": _gains(jax.tree_util.tree_map(np.asarray, params["params"]), np.random.default_rng(1))}
        port = t_hifigan.HifiGANGenerator(num_mels=NUM_MELS, **cfg).eval()
        W.load_numpy_state(port, W.hifigan_generator_from_jax(params["params"]))
        _BUILT[geometry] = (g, params, port)
    return _BUILT[geometry]


def _feats(t, seed=2):
    return np.random.default_rng(seed).normal(size=(2, t, NUM_MELS)).astype(np.float32)


def _port_full(port, feats):
    with torch.inference_mode():
        return port(torch.as_tensor(feats)).reshape(feats.shape[0], -1).numpy()


@pytest.mark.parametrize("which", ["tiny", "csmsc", "recipe", "tiny-ae"])
def test_receptive_field_matches_jax(which):
    if which == "recipe":
        cfg = dict(Config(os.path.join(ROOT, "examples", "csmsc", "configs", "msmc_vq_gan.yaml")).task["autoencoder"]["decoder_config"])
    elif which == "tiny-ae":
        cfg = dict(tiny_ae_config("/unused").task["autoencoder"]["decoder_config"])
    else:
        cfg = GEOMETRIES[which]
    got = t_hifigan.receptive_field_frames(cfg)
    assert got == j_receptive_field_frames(cfg)
    if which in ("csmsc", "recipe"):
        assert got == 20  # the CSMSC radius: chunk 64 -> a 104-frame window


@pytest.mark.parametrize("chunk", [4, 8, 13])
@pytest.mark.parametrize("geometry", ["tiny", "csmsc"])
def test_stream_equals_monolithic_and_jax(geometry, chunk):
    g, params, port = _pair(geometry)
    cfg = GEOMETRIES[geometry]
    t = FRAMES[geometry]
    feats = _feats(t)
    sd = StreamingDecoder.from_generator(port, cfg, chunk_frames=chunk)
    assert t > sd.window_frames and sd.hop == int(np.prod(cfg["upsample_rates"]))
    chunks = list(sd.stream(torch.as_tensor(feats)))
    got = np.concatenate(chunks, axis=1)

    # the port against its own monolithic decode. It does not hold
    # bit-exactly on the CPU: the convs of a window and of the whole
    # sequence sum in another order (oneDNN picks its algorithm by length),
    # a few ulp apart (2.7e-7 in the tiny geometry at chunk 4), so it is
    # held to SELF_TOL. The fallback below, one full decode, is bit-exact.
    want_self = _port_full(port, feats)
    assert got.shape == want_self.shape == (2, t * sd.hop)
    np.testing.assert_allclose(got, want_self, atol=SELF_TOL, rtol=0)

    # the JAX package's stream on the same weights and input
    with jax.default_matmul_precision("highest"):
        jsd = JStreamingDecoder.from_generator(g, params, cfg, chunk_frames=chunk)
        jchunks = list(jsd.stream(jnp.asarray(feats)))
    assert [c.shape for c in chunks] == [c.shape for c in jchunks]
    assert sd.window_frames == jsd.window_frames and sd.context_frames == jsd.context_frames
    np.testing.assert_allclose(got, np.concatenate(jchunks, axis=1), atol=JAX_TOL, rtol=0)
    assert np.abs(got).max() > 1e-2


def test_chunk_boundaries():
    """Chunk i carries samples [i*S*hop, min(T, (i+1)*S)*hop)."""
    _, _, port = _pair("tiny")
    sd = StreamingDecoder.from_generator(port, TINY_CFG, chunk_frames=5)
    t = sd.window_frames + 13
    sizes = [c.shape[1] for c in sd.stream(_feats(t))]
    assert sizes == [5 * sd.hop] * (t // 5) + ([t % 5 * sd.hop] if t % 5 else [])


@pytest.mark.parametrize("shorter", [3, 0])
def test_short_utterance_falls_back_to_the_full_decode(shorter):
    g, params, port = _pair("tiny")
    sd = StreamingDecoder.from_generator(port, TINY_CFG, chunk_frames=64)
    t = sd.window_frames - shorter
    feats = _feats(t)
    chunks = list(sd.stream(feats))
    assert len(chunks) == 1
    np.testing.assert_array_equal(chunks[0], _port_full(port, feats))
    with jax.default_matmul_precision("highest"):
        want = JStreamingDecoder.from_generator(g, params, TINY_CFG, chunk_frames=64).decode(jnp.asarray(feats))
    np.testing.assert_allclose(chunks[0], want, atol=JAX_TOL, rtol=0)


def test_every_window_runs_the_fused_mrf_layers(monkeypatch):
    """In eval() each window decode goes through ``fused_resblock_layer``
    (the kernel's wrapper): 4 stages x 3 blocks x 3 dilations = 36 layers
    per window in the CSMSC geometry, as in the monolithic decode."""
    _, _, port = _pair("csmsc")
    calls = []
    real = t_hifigan.fused_resblock_layer

    def counted(x, *args, **kw):
        calls.append(tuple(x.shape))
        return real(x, *args, **kw)

    monkeypatch.setattr(t_hifigan, "fused_resblock_layer", counted)
    sd = StreamingDecoder.from_generator(port, CSMSC_CFG, chunk_frames=13)
    t = FRAMES["csmsc"]
    n_chunks = sum(1 for _ in sd.stream(_feats(t)))
    assert n_chunks == -(-t // 13)
    assert len(calls) == 36 * n_chunks
    # every window has one shape: the window's frames times each stage's rate
    stage_lengths = {shape[1] for shape in calls}
    assert stage_lengths == {sd.window_frames * r for r in (6, 30, 150, 300)}


def test_from_feature_fn_streams_any_decoder():
    """A features -> waveform callable streamed with a decoder config's
    receptive field (and with an explicit context) equals its full decode."""
    _, _, port = _pair("tiny")

    def decode_fn(f):
        return 0.5 * port(f)

    feats = _feats(FRAMES["tiny"])
    want = 0.5 * _port_full(port, feats)
    sd = StreamingDecoder.from_feature_fn(decode_fn, TINY_CFG, chunk_frames=8)
    assert sd.context_frames == t_hifigan.receptive_field_frames(TINY_CFG)
    np.testing.assert_allclose(sd.decode(feats), want, atol=SELF_TOL, rtol=0)
    wide = StreamingDecoder.from_feature_fn(decode_fn, TINY_CFG, chunk_frames=8, context_frames=20)
    assert wide.window_frames == 48
    np.testing.assert_allclose(wide.decode(feats), want, atol=SELF_TOL, rtol=0)


def test_refusals():
    _, _, port = _pair("tiny")
    with pytest.raises(ValueError, match="chunk_frames"):
        StreamingDecoder.from_generator(port, TINY_CFG, chunk_frames=0)
    sd = StreamingDecoder.from_generator(port, TINY_CFG, chunk_frames=4)
    with pytest.raises(ValueError, match=r"\[B, T, C\]"):
        next(sd.stream(np.zeros((5, NUM_MELS), np.float32)))
    trained = t_hifigan.HifiGANGenerator(num_mels=NUM_MELS, **TINY_CFG)  # train() mode
    with pytest.raises(RuntimeError, match="eval"):
        StreamingDecoder.from_generator(trained, TINY_CFG)
