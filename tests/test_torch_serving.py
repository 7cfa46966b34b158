"""The port's inference entry points against msmctts_tpu, on the CPU: the
task's serving surface (``max_frames_cap``, ``static_max_frames``,
``predict_stream``), ``serving.BatchingEngine`` held as
``tests/test_serving.py`` holds the JAX engine, the HTTP daemon
(``serve.py``) and the test-list CLI (``infer.py``). Weights: the tiny AE +
AM pair initialised in JAX (``test_torch_slice.tiny_pair``); nothing is
trained here."""

import base64
import http.client
import io
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch
import yaml

from msmctts_tpu.config import Config
from msmctts_tpu.data.datasets import feature_normalize as j_feature_normalize
from msmctts_tpu.data.loader import finite_loader as j_finite_loader
from msmctts_tpu.serving import parse_phone_string as j_parse_phone_string
from msmctts_tpu.tasks import build_task
from msmctts_tpu.training.base_trainer import build_dataset_from_config as j_build_dataset
from msmctts_tpu.utils.checkpoint import load_checkpoint
from msmctts_tpu_torch import infer as t_infer
from msmctts_tpu_torch import serve as t_serve
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.serving import BatchingEngine, parse_phone_string
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint as t_load_checkpoint
from tests.test_torch_slice import tiny_pair  # noqa: F401  (module fixture)
from tests.tiny import FRAMESHIFT, MEL_DIM

torch.set_num_threads(2)

SR = 1600  # the tiny corpus's rate
WAV_TOL = 1e-4  # port vs JAX, as test_torch_slice.py::test_predict_matches_jax
SOLO_TOL = 1e-6  # a request in a coalesced batch vs the same request alone
TEXTS = ["3_1 5_2 7_0 2_1", "4_2 6_1", "1_1 2_2 3_3 4_4 5_0 6_1"]


def _jax_task(path):
    ck = load_checkpoint(path)
    task = build_task(Config(ck["config"]), mode="infer")
    task.load_variables(ck["state"])
    task.pre_infer()
    return task


def _port_task(path):
    ck = t_load_checkpoint(path)
    task = t_build_task(TConfig(ck["config"]), device="cpu")
    task.load_variables(ck["state"])
    task.pre_infer()
    return task


@pytest.fixture(scope="module")
def port_task(tiny_pair):
    return _port_task(tiny_pair["am"])


def _engine(task, **kw):
    kw.setdefault("sample_rate", SR)
    kw.setdefault("batch_size", 4)
    kw.setdefault("text_length", 32)
    return BatchingEngine(task, **kw)


def _batch(forced, frames_per_phone=None):
    rng = np.random.default_rng(3)
    B, Lt = 3, 16
    text_length = np.array([12, 7, 16])
    valid = np.arange(Lt)[None] < text_length[:, None]
    text = np.stack([rng.integers(1, 20, (B, Lt)), rng.integers(0, 5, (B, Lt))], -1) * valid[..., None]
    batch = {"text": text.astype(np.int32), "text_length": text_length.astype(np.int32)}
    if forced:
        lo, hi = frames_per_phone or (1, 6)
        batch["dur"] = (rng.integers(lo, hi, (B, Lt)) * valid).astype(np.float32)
    return batch


def _hold_predict(got, want):
    np.testing.assert_array_equal(got["duration"], np.asarray(want["duration"]))
    np.testing.assert_array_equal(got["mel_length"], np.asarray(want["mel_length"]))
    for a, b in zip(got["embedding"], want["embedding"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b, n in zip(got["wav"], want["wav"], got["mel_length"]):
        assert a.shape == (int(n) * FRAMESHIFT,)
        np.testing.assert_allclose(a, np.asarray(b), atol=WAV_TOL, rtol=0)


# ------------------------------------------------------------ task surface


@pytest.mark.parametrize("text", ["3_1 5_2 7_0", "  3_1_0   5_2_1 ", "7", "3_1 5", "", "3_x"])
def test_parse_phone_string_matches_jax(text):
    try:
        want = j_parse_phone_string(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_phone_string(text)
        assert str(got.value) == str(e)
        return
    got = parse_phone_string(text)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("forced", [True, False], ids=["forced-durations", "predicted-durations"])
def test_predict_under_the_cap_matches_jax(tiny_pair, port_task, forced):
    """``max_frames_cap`` clamps every total (here below the longest
    utterance, so the cap bites) in both duration modes."""
    batch = _batch(forced)
    cap = 40
    jtask = _jax_task(tiny_pair["am"])
    jtask.max_frames_cap = cap
    with jax.default_matmul_precision("highest"):
        want = jtask.infer_step(batch)
    port_task.max_frames_cap = cap
    try:
        got = port_task.infer_step(batch)
    finally:
        port_task.max_frames_cap = None
    assert int(np.max(want["mel_length"])) == cap
    _hold_predict(got, want)
    assert ("syn", 16, 64) in port_task.shapes
    assert (("dur", 16) in port_task.shapes) or forced


def test_predict_in_static_frames_mode_matches_jax(tiny_pair, port_task):
    batch = _batch(False)
    jtask = _jax_task(tiny_pair["am"])
    jtask.static_max_frames = 128
    with jax.default_matmul_precision("highest"):
        want = jtask.infer_step(batch)
        dynamic = _jax_task(tiny_pair["am"]).infer_step(batch)
    port_task.static_max_frames = 128
    try:
        got = port_task.infer_step(batch)
    finally:
        port_task.static_max_frames = None
    assert ("syn", 16, 128) in port_task.shapes
    _hold_predict(got, want)
    # the static bucket gives the dynamic path's audio
    for a, b in zip(got["wav"], dynamic["wav"]):
        np.testing.assert_allclose(a, np.asarray(b), atol=WAV_TOL, rtol=0)


def test_predict_stream_matches_jax(tiny_pair, port_task):
    """Chunk 4 on forced durations of 3-6 frames a phone (36-96 frames, a
    30-frame window): many chunks. meta equal to JAX's, the chunks' shapes
    equal, the concatenation within WAV_TOL of JAX's and within SOLO_TOL of
    the port's own ``predict``."""
    batch = _batch(True, frames_per_phone=(3, 7))
    jtask = _jax_task(tiny_pair["am"])
    with jax.default_matmul_precision("highest"):
        jmeta, jchunks = jtask.predict_stream(batch, chunk_frames=4)
        jchunks = [np.asarray(c) for c in jchunks]
    meta, chunks = port_task.predict_stream(batch, chunk_frames=4)
    chunks = list(chunks)
    assert len(chunks) >= 3 and [c.shape for c in chunks] == [c.shape for c in jchunks]
    assert set(meta) == set(jmeta) == {"mel_length", "wav_length", "hop", "duration"}
    assert meta["hop"] == jmeta["hop"] == FRAMESHIFT
    for k in ("mel_length", "wav_length", "duration"):
        np.testing.assert_array_equal(meta[k], np.asarray(jmeta[k]))
    got = np.concatenate(chunks, axis=1)
    np.testing.assert_allclose(got, np.concatenate(jchunks, axis=1), atol=WAV_TOL, rtol=0)
    mono = port_task.predict(batch)
    for i, w in enumerate(mono["wav"]):
        np.testing.assert_allclose(got[i, : meta["wav_length"][i]], w, atol=SOLO_TOL, rtol=0)
    assert ("stream", 4, 16, 128) in port_task.shapes


def test_predict_stream_runs_each_step_under_inference_mode(port_task):
    """The chunk generator runs in whichever thread consumes it, with grad
    mode on there: each step takes inference mode itself."""
    meta, chunks = port_task.predict_stream(_batch(True, frames_per_phone=(3, 7)), chunk_frames=4)
    out = []
    t = threading.Thread(target=lambda: out.extend(chunks))
    with torch.enable_grad():
        t.start()
        t.join(120)
    assert not t.is_alive() and len(out) >= 3 and sum(c.shape[1] for c in out) >= int(meta["wav_length"].max())


# ---------------------------------------------------------------- engine


def test_single_request_roundtrip(port_task):
    eng = _engine(port_task, window_ms=0.0).start()
    try:
        wav = eng.synthesize("3_1 5_2 7_0 2_1", timeout=120)
        assert wav.ndim == 1 and wav.shape[0] > 0 and np.isfinite(wav).all()
        snap = eng.snapshot()
        assert snap["requests"] == 1 and snap["batches"] == 1 and snap["audio_seconds"] > 0
    finally:
        eng.stop()
        port_task.max_frames_cap = None


def test_concurrent_requests_coalesce_and_match_solo(port_task):
    """3 concurrent requests ride one batch; each result equals the same
    text synthesized alone (padding rows are inert)."""
    eng = _engine(port_task, window_ms=0.0).start()
    try:
        solo = [eng.synthesize(t, timeout=120) for t in TEXTS]
        assert eng.stats.batches == 3  # window 0: no coalescing
    finally:
        eng.stop()
    eng = _engine(port_task, window_ms=500.0).start()
    try:
        results = [None] * len(TEXTS)

        def run(i):
            results[i] = eng.synthesize(TEXTS[i], timeout=120)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(TEXTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        snap = eng.snapshot()
        assert snap["requests"] == 3 and snap["batches"] < 3 and snap["mean_batch_size"] > 1
        for got, want in zip(results, solo):
            np.testing.assert_allclose(got, want, atol=SOLO_TOL, rtol=0)
    finally:
        eng.stop()
        port_task.max_frames_cap = None


def test_a_batch_holds_requests_of_one_text_length(port_task):
    """Every batch pads its text to the engine's one length (32): requests
    of 4, 2 and 20 phones share a batch. Longer ones (40 and 36 phones, 64
    padded) ride a batch of their own after them, and each request equals
    the same request alone: a request's text shape is its own."""
    long_texts = [" ".join(f"{i % 19 + 1}_{i % 5}" for i in range(n)) for n in (40, 20, 36)]
    texts = [TEXTS[0], long_texts[0], TEXTS[1], long_texts[1], long_texts[2]]
    eng = _engine(port_task, window_ms=0.0).start()
    try:
        solo = [eng.synthesize(t, timeout=120) for t in texts]
    finally:
        eng.stop()
    eng = _engine(port_task, window_ms=500.0).start()
    ran = []
    run_batch = eng._run_batch
    eng._run_batch = lambda reqs: (ran.append([r.text.shape[0] for r in reqs]), run_batch(reqs))
    try:
        results = [None] * len(texts)

        def run(i):
            results[i] = eng.synthesize(texts[i], timeout=120)

        threads = []
        for i in range(len(texts)):
            threads.append(threading.Thread(target=run, args=(i,)))
            threads[-1].start()
            time.sleep(0.02)  # arrival order: 4, 40, 2, 20, 36 phones
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert ran == [[4, 2, 20], [40, 36]]
        assert ("dur", 32) in port_task.shapes and ("dur", 64) in port_task.shapes
        for got, want in zip(results, solo):
            np.testing.assert_allclose(got, want, atol=SOLO_TOL, rtol=0)
    finally:
        eng.stop()
        port_task.max_frames_cap = None


def test_warmup_leaves_no_cold_shape(tiny_pair):
    """After ``warmup()`` no request, whatever frame bucket it lands in, runs
    a shape the warmup did not: ``cold_shapes`` stays 0 over a sweep of
    lengths, streaming included; ``kernel_builds`` is 0 on the CPU."""
    task = _port_task(tiny_pair["am"])
    eng = _engine(task, max_frames=128, window_ms=0.0, stream_chunk_frames=8).start()
    try:
        assert eng.cold_shapes() == 0 and not task.shapes
        secs = eng.warmup()
        assert secs > 0 and eng._streaming_warm
        for Lt in (32,):
            assert ("dur", Lt) in task.shapes
            for F in eng._reachable_frame_buckets():
                assert ("syn", Lt, F) in task.shapes and ("stream", 8, Lt, F) in task.shapes
        assert eng._reachable_frame_buckets() == [64, 128]
        rng = np.random.default_rng(4)
        for n in (1, 2, 5, 9, 16, 17, 24, 32):
            text = np.stack([rng.integers(1, 20, n), rng.integers(0, 5, n)], -1)
            assert np.isfinite(eng.synthesize(text, timeout=120)).all()
        assert np.concatenate(list(eng.synthesize_stream(TEXTS[2], timeout=120))).size > 0
        snap = eng.snapshot()
        assert snap["cold_shapes"] == 0 and snap["kernel_builds"] == 0 and snap["errors"] == 0
        # a shape the warmup did not run counts
        task.predict({"text": np.ones((4, 48, 2), np.int32), "text_length": np.full(4, 40, np.int32)})
        assert eng.snapshot()["cold_shapes"] >= 1
    finally:
        eng.stop()


def test_warmup_of_a_started_engine_runs_on_its_worker_thread(port_task, monkeypatch):
    """``start(warmup=...)`` warms on the worker thread, which then serves:
    PyTorch keeps cuDNN's execution plans per thread. A warmup that fails
    is raised by ``start`` and leaves the engine stopped."""
    threads = []
    real = port_task.infer_step

    def recorded(batch):
        threads.append(threading.current_thread().name)
        return real(batch)

    monkeypatch.setattr(port_task, "infer_step", recorded)
    eng = _engine(port_task, max_frames=64, window_ms=0.0)
    try:
        eng.start(warmup={"text_lengths": [4], "include_streaming": False})
        assert eng.warmup_s > 0 and eng.cold_shapes() == 0 and len(threads) >= 2
        eng.synthesize("3_1 5_2", timeout=120)
    finally:
        eng.stop()
        port_task.max_frames_cap = None
    assert set(threads) == {"tts-batcher"}

    def broken(batch):
        raise RuntimeError("warmup broke")

    monkeypatch.setattr(port_task, "infer_step", broken)
    eng = _engine(port_task, max_frames=64)
    try:
        with pytest.raises(RuntimeError, match="warmup broke"):
            eng.start(warmup={"text_lengths": [4]})
        with pytest.raises(RuntimeError, match="not started"):
            eng.synthesize("3_1 5_2", timeout=10)
    finally:
        port_task.max_frames_cap = None


def test_kernel_builds_count_from_the_end_of_warmup(port_task, monkeypatch):
    """``kernel_builds`` counts nvcc builds since ``warmup()`` ended, as
    ``cold_shapes`` counts shapes: a server that built its libraries while
    warming up reads 0 under traffic; with no warmup every build counts."""
    from msmctts_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "_BUILDS", [2])  # built before the engine
    real = port_task.infer_step

    def building(batch):  # a library built during warmup
        cuda_build._BUILDS[0] += 1
        return real(batch)

    eng = _engine(port_task, max_frames=64, window_ms=0.0)
    try:
        assert eng.snapshot()["kernel_builds"] == 2
        monkeypatch.setattr(port_task, "infer_step", building)
        eng.warmup(text_lengths=[4], include_streaming=False)
        assert cuda_build.build_count() > 2 and eng.snapshot()["kernel_builds"] == 0
        cuda_build._BUILDS[0] += 1  # one under traffic
        assert eng.snapshot()["kernel_builds"] == 1
    finally:
        port_task.max_frames_cap = None


def test_cold_streaming_is_refused(port_task):
    eng = _engine(port_task, window_ms=0.0).start()
    try:
        eng.warmup(text_lengths=[4], include_streaming=False)
        assert not eng._streaming_warm
        with pytest.raises(RuntimeError, match="cold"):
            next(iter(eng.synthesize_stream("3_1 5_2", timeout=10)))
        assert np.isfinite(eng.synthesize("3_1 5_2", timeout=120)).all()  # still serving
    finally:
        eng.stop()
        port_task.max_frames_cap = None


def test_the_cap_truncates(port_task):
    """A request whose frames exceed ``max_frames`` is cut at the cap."""
    eng = _engine(port_task, max_frames=64)
    try:
        assert port_task.max_frames_cap == 64
        batch = {"text": np.asarray([[[3, 1], [5, 2]]], np.int32), "text_length": np.asarray([2], np.int32),
                 "dur": np.asarray([[200.0, 200.0]], np.float32)}
        out = port_task.predict(batch)
        assert int(out["mel_length"][0]) == 64 and out["wav"][0].shape == (64 * FRAMESHIFT,)
        meta, chunks = port_task.predict_stream(batch, chunk_frames=8)
        assert int(meta["mel_length"][0]) == 64
        np.testing.assert_allclose(np.concatenate(list(chunks), axis=1)[0, : 64 * FRAMESHIFT], out["wav"][0],
                                   atol=SOLO_TOL, rtol=0)
    finally:
        port_task.max_frames_cap = None
    assert eng.max_frames == 64


def test_errors_reach_blocking_and_streaming_callers(port_task, monkeypatch):
    eng = _engine(port_task, stream_chunk_frames=8).start()
    try:
        with pytest.raises(ValueError):
            eng.synthesize(np.zeros((0, 2), np.int32), timeout=10)
        with pytest.raises(ValueError, match="2-stream"):
            eng.synthesize("3_1_0 5_2_0", timeout=10)
        real = port_task.infer_step
        calls = {"n": 0}

        def flaky(batch):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected device failure")
            return real(batch)

        monkeypatch.setattr(port_task, "infer_step", flaky)
        with pytest.raises(RuntimeError, match="injected device"):
            eng.synthesize("3_1 5_2", timeout=120)
        assert np.isfinite(eng.synthesize("3_1 5_2", timeout=120)).all()  # still serving

        def boom(batch, chunk_frames):
            raise RuntimeError("injected streaming failure")

        monkeypatch.setattr(port_task, "predict_stream", boom)
        with pytest.raises(RuntimeError, match="injected streaming"):
            list(eng.synthesize_stream("3_1 5_2", timeout=120))
        monkeypatch.undo()
        assert np.isfinite(eng.synthesize("3_1 5_2", timeout=120)).all()
        assert eng.stats.errors == 2
    finally:
        eng.stop()
        port_task.max_frames_cap = None


def test_streaming_and_blocking_coalesce(port_task):
    """A streaming and a blocking request ride ONE batch; both equal their
    solo syntheses, and the stream equals the blocking result of its text."""
    t_stream, t_block = TEXTS[2], TEXTS[1]
    eng = _engine(port_task, window_ms=0.0, stream_chunk_frames=4).start()
    try:
        solo_s = eng.synthesize(t_stream, timeout=120)
        solo_b = eng.synthesize(t_block, timeout=120)
        alone = list(eng.synthesize_stream(t_stream, timeout=120))
    finally:
        eng.stop()
    assert len(alone) >= 2
    np.testing.assert_allclose(np.concatenate(alone), solo_s, atol=SOLO_TOL, rtol=0)
    eng = _engine(port_task, window_ms=500.0, stream_chunk_frames=4).start()
    try:
        out = {}
        threads = [
            threading.Thread(target=lambda: out.update(s=np.concatenate(list(eng.synthesize_stream(t_stream, timeout=120))))),
            threading.Thread(target=lambda: out.update(b=eng.synthesize(t_block, timeout=120))),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        deadline = time.time() + 30  # results are delivered before the counters move
        while eng.stats.requests < 2 and time.time() < deadline:
            time.sleep(0.02)
        assert eng.stats.batches == 1
        np.testing.assert_allclose(out["s"], solo_s, atol=SOLO_TOL, rtol=0)
        np.testing.assert_allclose(out["b"], solo_b, atol=SOLO_TOL, rtol=0)
    finally:
        eng.stop()
        port_task.max_frames_cap = None


def test_hot_reload_gives_a_fresh_task_on_the_new_weights(tiny_pair):
    """``reload`` swaps the weights between batches: after it the engine
    gives what a task freshly loaded with the new weights gives, streaming
    included; swapping back gives the first audio again."""
    task = _port_task(tiny_pair["am"])
    state = t_load_checkpoint(tiny_pair["am"])["state"]
    bumped = {"params": {"predictor": jax.tree_util.tree_map(lambda x: np.asarray(x) * 1.5, state["params"]["predictor"])}}
    fresh = _port_task(tiny_pair["am"])
    fresh.load_variables(bumped)
    text = TEXTS[0]
    eng = _engine(task, window_ms=0.0, stream_chunk_frames=4).start()
    try:
        w_old = eng.synthesize(text, timeout=120)
        eng.reload(bumped)
        w_new = eng.synthesize(text, timeout=120)
        s_new = np.concatenate(list(eng.synthesize_stream(text, timeout=120)))
        eng.reload(state)
        w_back = eng.synthesize(text, timeout=120)
        assert eng.stats.errors == 0
    finally:
        eng.stop()
    want_wav = fresh.infer_step(_solo_batch(_engine(fresh), text))["wav"][0]
    assert w_new.shape != w_old.shape or not np.allclose(w_new, w_old)
    np.testing.assert_allclose(w_new, want_wav, atol=SOLO_TOL, rtol=0)
    np.testing.assert_allclose(s_new, want_wav, atol=SOLO_TOL, rtol=0)
    np.testing.assert_array_equal(w_back, w_old)


def _solo_batch(eng, text):
    """The batch the engine builds for one request."""
    arr = parse_phone_string(text)
    Lt = 16
    t = np.zeros((eng.batch_size, Lt, arr.shape[1]), np.int32)
    t[:] = np.pad(arr, ((0, Lt - arr.shape[0]), (0, 0)))
    return {"text": t, "text_length": np.full(eng.batch_size, arr.shape[0], np.int32)}


def test_hot_reload_rebuilds_the_prepared_mrf_taps(tiny_pair):
    """The fused MRF layers keep folded and prepared taps beside the weights;
    a reload of the autoencoder refreshes them through the load hook."""
    task = _port_task(tiny_pair["ae"])
    block = task.networks["autoencoder"].decoder.resblocks[0]
    before = block.taps1_0.clone()
    state = t_load_checkpoint(tiny_pair["ae"])["state"]
    scaled = dict(state, params={"autoencoder": jax.tree_util.tree_map(lambda x: np.asarray(x) * 2.0, state["params"]["autoencoder"])})
    BatchingEngine(task, sample_rate=SR).reload(scaled)
    assert not torch.equal(block.taps1_0, before)
    v, g = block.convs1[0].weight_v, block.convs1[0].weight_g
    from msmctts_tpu_torch.ops.convs import fold_weight_norm

    torch.testing.assert_close(block.taps1_0, fold_weight_norm(v, g).permute(2, 1, 0), rtol=0, atol=0)


def test_a_full_queue_raises_and_stop_fails_queued_requests(port_task, monkeypatch):
    """With the worker inside a batch: a full queue refuses the next request,
    and ``stop()`` fails the queued ones (blocking and streaming) while the
    batch in flight completes."""
    entered, go = threading.Event(), threading.Event()
    real = port_task.infer_step

    def gated(batch):
        entered.set()
        go.wait(60)
        return real(batch)

    monkeypatch.setattr(port_task, "infer_step", gated)
    eng = _engine(port_task, max_queue=2, window_ms=0.0).start()
    out = {}
    inflight = threading.Thread(target=lambda: out.update(wav=eng.synthesize(TEXTS[0], timeout=120)))
    inflight.start()
    try:
        assert entered.wait(60)
        blocked = eng._submit(TEXTS[1], stream=False)
        streamed = eng._submit(TEXTS[2], stream=True)
        with pytest.raises(RuntimeError, match="overloaded"):
            eng.synthesize(TEXTS[2], timeout=5)
        assert eng.stats.errors == 1
        stopper = threading.Thread(target=eng.stop)
        stopper.start()
        assert blocked.done.wait(30) and "stopped" in str(blocked.error)
        assert isinstance(streamed.chunk_q.get(timeout=30), RuntimeError)
    finally:
        go.set()
        inflight.join(60)
        eng.stop()
    stopper.join(60)
    assert not stopper.is_alive() and np.isfinite(out["wav"]).all()
    port_task.max_frames_cap = None


def test_run_streaming_chunk_plumbing():
    """``_run_streaming`` slices every chunk per utterance, trims at each
    utterance's ``wav_length`` and routes the pieces (a fake task)."""

    class FakeTask:
        def predict_stream(self, batch, chunk_frames):
            full = np.arange(24, dtype=np.float32).reshape(2, 12)
            return {"wav_length": np.array([10, 4]), "hop": 1}, (full[:, o : o + 5] for o in range(0, 12, 5))

    from msmctts_tpu_torch.serving import _Request

    eng = BatchingEngine(FakeTask(), sample_rate=SR, batch_size=4, text_length=8, stream_chunk_frames=5)
    r_stream, r_block = _Request(np.zeros((3, 2), np.int32), stream=True), _Request(np.zeros((3, 2), np.int32))
    audio = eng._run_streaming([r_stream, r_block], batch={})
    pieces = []
    while (item := r_stream.chunk_q.get_nowait()) is not None:
        pieces.append(item)
    assert [p.shape[0] for p in pieces] == [5, 5]
    np.testing.assert_array_equal(np.concatenate(pieces), np.arange(10.0))
    np.testing.assert_array_equal(r_block.wav, np.arange(12.0, 16.0))
    assert abs(audio - 14 / SR) < 1e-9


# ------------------------------------------------------------------ HTTP


def test_http_server_end_to_end(port_task):
    from http.server import ThreadingHTTPServer

    from scipy.io import wavfile

    eng = _engine(port_task, window_ms=5.0, stream_chunk_frames=4).start()
    ready = threading.Event()
    server = ThreadingHTTPServer(("127.0.0.1", 0), t_serve.make_handler(eng, ready, request_timeout=120))
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()
    try:
        def request(method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", server.server_port, timeout=120)
            conn.request(method, path, body=json.dumps(body) if body is not None else None,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
            return resp.status, resp.getheader("Content-Type"), data

        assert request("POST", "/synthesize", {"text": "3_1 5_2"})[0] == 503
        assert request("GET", "/healthz")[0] == 503
        ready.set()
        status, _, data = request("GET", "/healthz")
        assert status == 200 and json.loads(data)["status"] == "ok"

        status, ctype, data = request("POST", "/synthesize", {"text": TEXTS[2]})
        assert status == 200 and ctype == "audio/wav"
        sr, pcm = wavfile.read(io.BytesIO(data))
        blocking = eng.synthesize(TEXTS[2], timeout=120)
        assert sr == SR and pcm.dtype == np.int16
        np.testing.assert_array_equal(pcm, np.frombuffer(t_serve.pcm16(blocking), "<i2"))

        status, ctype, data = request("POST", "/synthesize", {"text": "3_1 5_2", "format": "json"})
        payload = json.loads(data)
        assert status == 200 and ctype == "application/json"
        sr2, pcm2 = wavfile.read(io.BytesIO(base64.b64decode(payload["wav_b64"])))
        assert sr2 == SR == payload["sample_rate"] and pcm2.shape[0] > 0 and payload["duration_s"] > 0

        # chunked streaming WAV: its PCM is pcm16 of the blocking wav
        status, ctype, data = request("POST", "/synthesize", {"text": TEXTS[2], "stream": True})
        assert status == 200 and ctype == "audio/wav"
        assert data[:4] == b"RIFF" and data[8:12] == b"WAVE" and data[:44] == t_serve.streaming_wav_header(SR)
        stream_pcm = np.frombuffer(data[44:], "<i2")
        np.testing.assert_allclose(stream_pcm.astype(np.int32), pcm.astype(np.int32), atol=1, rtol=0)

        assert request("POST", "/synthesize", {"nope": 1})[0] == 400
        assert request("POST", "/synthesize", {"text": ""})[0] == 400
        assert request("GET", "/nowhere")[0] == 404

        status, _, data = request("GET", "/stats")
        stats = json.loads(data)
        assert status == 200 and stats["requests"] >= 4 and stats["latency_s"]["p50"] is not None
        assert {"cold_shapes", "kernel_builds", "mean_batch_size", "task_realtime_factor", "errors"} <= set(stats)
        assert "xla_compiles" not in stats
    finally:
        server.shutdown()
        srv.join(timeout=10)
        server.server_close()
        eng.stop()
        port_task.max_frames_cap = None


def test_wav_bytes_are_what_scipy_writes():
    from scipy.io import wavfile

    wav = np.random.default_rng(7).uniform(-1.2, 1.2, 1001).astype(np.float32)
    buf = io.BytesIO()
    wavfile.write(buf, SR, (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16))
    assert t_serve.wav_bytes(wav, SR) == buf.getvalue()
    assert t_serve.streaming_wav_header(SR) == buf.getvalue()[:4] + b"\xff" * 4 + buf.getvalue()[8:40] + b"\xff" * 4


def test_serve_cli_warmup_only_on_cpu(tiny_pair, capsys):
    rc = t_serve.main(["-m", tiny_pair["am"], "--device", "cpu", "--warmup-only", "--batch-size", "2",
                       "--max-frames", "64", "--warmup-lengths", "8", "--stream-chunk-frames", "8"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["streaming_warmed"] and line["device"] == "cpu"
    assert line["warmup_s"] > 0 and line["shapes"] == 3  # ("dur", 256), ("syn", 256, 64), ("stream", 8, 256, 64)


def test_serve_cli_engine_keeps_the_frame_margin(tiny_pair, capsys):
    """The daemon's task has not loaded its autoencoder when the engine is
    built; the engine's frame margin is still the autoencoder's reach."""
    rc = t_serve.main(["-m", tiny_pair["am"], "--device", "cpu", "--warmup-only", "--batch-size", "2",
                       "--max-frames", "64", "--warmup-lengths", "8", "--no-warmup-streaming"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["frame_margin"] == _port_task(tiny_pair["am"]).padding_reach_frames() > 0


@pytest.mark.parametrize("flag,item", [
    (["--artifact", "x"], "--artifact"), (["--mesh-devices", "2", "--artifact", "x"], "from one process"),
], ids=["artifact", "mesh-devices"])
def test_serve_cli_refuses_what_is_not_ported(tiny_pair, capsys, flag, item):
    with pytest.raises(SystemExit) as e:
        t_serve.main(["-m", tiny_pair["am"], "--device", "cpu", *flag])
    assert e.value.code != 0 and item in capsys.readouterr().err


def test_entry_points_refuse_the_cpu_unless_asked(tiny_pair, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.main(["-m", tiny_pair["am"], "--warmup-only"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_infer.main(["-m", tiny_pair["am"], "-t", str(tmp_path / "t.yaml"), "-o", str(tmp_path)])


# ----------------------------------------------------------------- infer


def _write_cfg(path, cfg: dict):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _jax_infer(config_path, model, test_list, batch_size):
    """What the JAX package's infer.py saves, from its own functions."""
    ck = load_checkpoint(model)
    config = Config(config_path) if config_path else Config(ck["config"])
    task = build_task(config, mode="infer")
    task.load_variables(ck["state"])
    test_config = Config(config.to_dict())
    test_config["dataset"] = config.get("testset", config.dataset)
    dataset = j_build_dataset(test_config, training=False, id_list=test_list)
    out = {}
    with jax.default_matmul_precision("highest"):
        for batch in j_finite_loader(dataset, batch_size):
            ids = batch.pop("_id")
            res = task.infer_step(batch)
            for j, i in enumerate(ids):
                name = dataset.id_list[int(i)][0]
                for key in ("wav", "embedding", "duration"):
                    if key in res:
                        feat = np.asarray(res[key][j])
                        if key in dataset.feature_stat:
                            feat = j_feature_normalize(feat, dataset.feature_stat[key], denormalize=True)
                        out[(name, key)] = feat
    return out


def test_infer_cli_autoencoder_mode_matches_jax(tiny_pair, tmp_path):
    """Analysis-synthesis of a test list of mel files, the wav denormalized
    by a ``feature_stat`` (scale and shift), saved as .npy, .wav, .txt and
    .dat."""
    rng = np.random.default_rng(5)
    lists = {}
    for i, T in enumerate((11, 24, 17)):
        p = str(tmp_path / f"mel{i}.npy")
        np.save(p, rng.normal(size=(T, MEL_DIM)).astype(np.float32))
        lists[f"utt{i}"] = {"mel": p}
    test_list = _write_cfg(str(tmp_path / "test_ae.yaml"), lists)
    stat = _write_cfg(str(tmp_path / "wav_stat.yaml"), {"scale": 2.0, "shift": 0.25})
    cfg = dict(t_load_checkpoint(tiny_pair["ae"])["config"])
    cfg["dataset"] = dict(cfg["dataset"], feature_stat=[None, stat])
    cfg["save_features"] = [["wav", ".npy"], ["wav", ".wav", SR], ["wav", ".txt"], ["wav", ".dat"]]
    cfg_path = _write_cfg(str(tmp_path / "ae.yaml"), cfg)
    out_dir = str(tmp_path / "out_ae")
    t_infer.main(["-m", tiny_pair["ae"], "-c", cfg_path, "-t", test_list, "-o", out_dir, "-b", "2", "--device", "cpu"])
    want = _jax_infer(cfg_path, tiny_pair["ae"], test_list, 2)
    for name in lists:
        got = np.load(os.path.join(out_dir, f"{name}_wav.npy"))
        ref = want[(name, "wav")]
        assert got.shape == ref.shape and got.shape[0] % FRAMESHIFT == 0
        np.testing.assert_allclose(got, ref, atol=WAV_TOL * 2.0, rtol=0)  # the stat's scale of 2 divides
        np.testing.assert_allclose(np.loadtxt(os.path.join(out_dir, f"{name}_wav.txt")), got, atol=1e-6)
        np.testing.assert_array_equal(np.fromfile(os.path.join(out_dir, f"{name}_wav.dat"), np.float32), got)
        assert os.path.getsize(os.path.join(out_dir, f"{name}_wav.wav")) > 44
    # the denormalization ran: (x - shift) / scale of a tanh output lies in [-0.625, 0.375]
    assert got.min() >= -0.625 - 1e-6 and got.max() <= 0.375 + 1e-6


@pytest.mark.parametrize("with_dur", [False, True], ids=["predicted-durations", "forced-durations"])
def test_infer_cli_acoustic_model_mode_matches_jax(tiny_pair, tmp_path, with_dur):
    """TTS of a test list of inline phone strings (with and without ``dur``),
    the embedding, duration and wav saved as .npy, the embedding also as a
    .png heatmap (matplotlib is installed here)."""
    cases = {"a": "3_1 5_2 7_0 2_1 9_3", "b": "4_2 6_1", "c": "1_1 2_2 3_3 4_4 5_0 6_1 8_2"}
    lists = {k: {"text": v} for k, v in cases.items()}
    if with_dur:
        rng = np.random.default_rng(6)
        for k, v in cases.items():
            lists[k]["dur"] = " ".join(str(int(d)) for d in rng.integers(1, 6, len(v.split())))
    test_list = _write_cfg(str(tmp_path / "test_am.yaml"), lists)
    cfg = dict(t_load_checkpoint(tiny_pair["am"])["config"])
    cfg["save_features"] = [["embedding", ".npy"], ["embedding", ".png"], ["duration", ".npy"], ["wav", ".npy"],
                            ["wav", ".wav", SR]]
    cfg_path = _write_cfg(str(tmp_path / "am.yaml"), cfg)
    out_dir = str(tmp_path / "out_am")
    t_infer.main(["-m", tiny_pair["am"], "-c", cfg_path, "-t", test_list, "-o", out_dir, "-b", "2", "--device", "cpu"])
    want = _jax_infer(cfg_path, tiny_pair["am"], test_list, 2)
    for name in cases:
        for key in ("embedding", "duration", "wav"):
            got = np.load(os.path.join(out_dir, f"{name}_{key}.npy"))
            ref = want[(name, key)]
            assert got.shape == ref.shape, (name, key)
            if key == "wav":
                np.testing.assert_allclose(got, ref, atol=WAV_TOL, rtol=0)
            else:
                np.testing.assert_array_equal(got, ref)
        assert os.path.getsize(os.path.join(out_dir, f"{name}_embedding.png")) > 0
        if with_dur:
            n = len(cases[name].split())
            np.testing.assert_array_equal(np.load(os.path.join(out_dir, f"{name}_duration.npy"))[:n],
                                          np.asarray(lists[name]["dur"].split(), np.float32))


@pytest.mark.parametrize("flag,item", [(["--mesh-devices", "0"], "must be given")], ids=["mesh-devices"])
def test_infer_cli_refuses_what_is_not_ported(tiny_pair, tmp_path, capsys, flag, item):
    with pytest.raises(SystemExit) as e:
        t_infer.main(["-m", tiny_pair["am"], "-t", str(tmp_path / "t.yaml"), "--device", "cpu", *flag])
    assert e.value.code != 0 and item in capsys.readouterr().err


def test_infer_skips_png_without_matplotlib(tmp_path, monkeypatch):
    import importlib.util

    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if name == "matplotlib" else object())
    base = str(tmp_path / "x_embedding")
    assert not t_infer.save_feature(base, ".png", np.ones((5, 3), np.float32))
    assert not os.path.exists(base + ".png")
    assert t_infer.save_feature(base, ".npy", np.ones((5, 3), np.float32))
    with pytest.raises(ValueError, match="extension"):
        t_infer.save_feature(base, ".bin", np.ones(3))
