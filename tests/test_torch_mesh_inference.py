"""Inference and serving over a group of ranks (``--mesh-devices``) on the
CPU: 2 gloo ranks (``msmctts_tpu_torch.parallel.launch.run_ranks``, the
rank functions in ``tests/torch_mesh_workers.py``) at the widths of
``tests/tiny.py``, against one port process and against the JAX package's
mesh runs (``tests/test_serving.py``'s mesh tests) on the same inputs. The
weights are the tiny AE + AM pair of ``test_torch_slice.tiny_pair``.

Tolerances:
  * 2 ranks against one port process: 1e-6 on every waveform (the rows'
    own rounding; observed bit-equal), int8 scales equal;
  * against the JAX package: 1e-4 (``WAV_TOL``, the port's float decode vs
    JAX's); the int8 decode 1e-2, as ``test_torch_int8.py`` holds a
    ``predict`` end to end (a rounding-level difference of the decoder's
    inputs can move a code by one step).
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import yaml

from msmctts_tpu.config import Config
from msmctts_tpu.parallel.mesh import make_mesh
from msmctts_tpu.serving import BatchingEngine as JBatchingEngine
from msmctts_tpu.tasks import build_task
from msmctts_tpu.utils.checkpoint import load_checkpoint
from msmctts_tpu_torch import infer as t_infer
from msmctts_tpu_torch.parallel import mesh
from msmctts_tpu_torch.parallel.launch import rank_devices, run_ranks
from msmctts_tpu_torch.serving import BatchingEngine
from tests import torch_mesh_workers as workers
from tests.test_torch_slice import tiny_pair  # noqa: F401  (module fixture)
from tests.torch_parallel_workers import build_inference_task

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = workers.SR
WAV_TOL = 1e-4
SOLO_TOL = 1e-6
INT8_TOL = 1e-2
TEXTS = ["3_1 5_2 7_0 2_1", "4_2 6_1", "1_1 2_2 3_3 4_4 5_0 6_1"]  # test_mesh_engine_matches_single_device's


def _ranks(fn, *args, timeout_s=180.0, **kw):
    return run_ranks(fn, 2, "gloo", ["cpu", "cpu"], *args, timeout_s=timeout_s, threads=2, **kw)


def _jax_task(path):
    ck = load_checkpoint(path)
    task = build_task(Config(ck["config"]), mode="infer")
    task.load_variables(ck["state"])
    task.pre_infer()
    return task


def _int8_batch():
    """``test_mesh_int8_matches_single_device``'s batch of 8."""
    rng = np.random.default_rng(1)
    return {"text": rng.integers(1, 5, size=(8, 8, 2)).astype(np.int32),
            "text_length": np.asarray([8, 6, 8, 5, 8, 8, 7, 8], np.int32)}


# ----------------------------------------------------------------------- int8


@pytest.fixture(scope="module")
def int8_runs(tiny_pair):
    batch = _int8_batch()
    one = build_inference_task(tiny_pair["am"])
    one.int8_decoder = True
    want = one.infer_step(batch)
    jtask = _jax_task(tiny_pair["am"])
    jtask.int8_decoder = True
    try:
        with jax.default_matmul_precision("highest"):
            jtask.use_mesh(make_mesh(8))
            jwant = jtask.infer_step(batch)
    finally:
        jtask.use_mesh(None)
    return dict(one=want, one_scales=dict(one._int8_state.scales), jax=jwant,
                ranks=_ranks(workers.int8_rank, tiny_pair["am"], batch))


def test_int8_over_two_ranks_matches_one_rank_and_the_jax_mesh(int8_runs):
    one, ranks = int8_runs["one"], int8_runs["ranks"]
    for r in ranks:  # every rank holds the one rank's scales and returns the whole batch
        assert r["scales"] == int8_runs["one_scales"]
        assert len(r["wav"]) == 8
        for got, want, jwant in zip(r["wav"], one["wav"], int8_runs["jax"]["wav"]):
            assert got.shape == want.shape == np.asarray(jwant).shape and got.size > 0
            np.testing.assert_allclose(got, want, atol=SOLO_TOL, rtol=0)
            np.testing.assert_allclose(got, np.asarray(jwant), atol=INT8_TOL, rtol=0)
    assert max(np.abs(w).max() for w in one["wav"]) > 1e-2


def test_int8_calibration_on_a_ranks_rows_alone_would_differ(int8_runs):
    """The global batch's calibration is needed: each rank's own rows give
    other scales (a site's range over half the batch), and so another
    decode."""
    ranks, scales = int8_runs["ranks"], int8_runs["one_scales"]
    moved = [sum(r["alone_scales"][k] != scales[k] for k in scales) for r in ranks]
    assert all(n > 0 for n in moved), moved
    one = int8_runs["one"]["wav"]
    gap = max(np.abs(r["alone_wav"][i][: len(w)] - w).max() for r in ranks for i, w in enumerate(one))
    assert gap > 1e-5, gap


# --------------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def engine_runs(tiny_pair):
    """The engine over 2 ranks (the JAX package's frame bucket, no margin),
    one port process's engine, and the JAX package's engine on a 4-device
    mesh, on the same three texts."""
    one_task = build_inference_task(tiny_pair["am"])
    eng = BatchingEngine(one_task, **workers.engine_kwargs())
    one_task.frame_margin = 0
    eng.start(warmup={"text_lengths": None, "include_streaming": None})
    try:
        one = [eng.synthesize(t, timeout=120) for t in TEXTS]
        one_stream = list(eng.synthesize_stream(TEXTS[0], timeout=120))
    finally:
        eng.stop()
    jtask = _jax_task(tiny_pair["am"])
    precision = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")  # the engine's worker thread too
    try:
        jeng = JBatchingEngine(jtask, sample_rate=SR, batch_size=4, window_ms=0.0, text_buckets=(8, 16),
                               max_frames=64, mesh=make_mesh(4)).start()
        try:
            jax_solo = [jeng.synthesize(t, timeout=300) for t in TEXTS]
            jax_stream = list(jeng.synthesize_stream(TEXTS[0], timeout=300))
        finally:
            jeng.stop()
    finally:
        jax.config.update("jax_default_matmul_precision", precision)
        jtask.use_mesh(None)
    ranks = _ranks(workers.engine_rank, tiny_pair["am"], TEXTS, True)
    return dict(one=one, one_stream=one_stream, jax=jax_solo, jax_stream=jax_stream, ranks=ranks)


def test_engine_over_two_ranks_matches_one_rank_and_the_jax_mesh_engine(engine_runs):
    served = engine_runs["ranks"][0]
    for got, want, jwant in zip(served["solo"], engine_runs["one"], engine_runs["jax"]):
        assert got.shape == want.shape == np.asarray(jwant).shape and got.size > 0
        np.testing.assert_allclose(got, want, atol=SOLO_TOL, rtol=0)
        np.testing.assert_allclose(got, np.asarray(jwant), atol=WAV_TOL, rtol=0)


def test_stream_over_two_ranks_matches_the_jax_mesh_engine_stream(engine_runs):
    served = engine_runs["ranks"][0]
    got = np.concatenate(served["stream"])
    assert len(served["stream"]) > 1 and served["streaming_warm"]
    np.testing.assert_allclose(got, np.concatenate(engine_runs["one_stream"]), atol=SOLO_TOL, rtol=0)
    np.testing.assert_allclose(got, np.concatenate([np.asarray(c) for c in engine_runs["jax_stream"]]),
                               atol=WAV_TOL, rtol=0)
    np.testing.assert_allclose(got, served["solo"][0], atol=SOLO_TOL, rtol=0)  # the stream is the decode


def test_engine_over_two_ranks_keeps_every_rank_warm(engine_runs):
    """No rank runs a shape after warmup or builds a kernel; /stats shows
    the follower's counters (reported at each batch's end), and warmup's
    collectives ran on the world group: one header, all-gathers."""
    served, follower = engine_runs["ranks"]
    stats = served["stats"]
    assert stats["cold_shapes"] == 0 == stats["kernel_builds"] and stats["errors"] == 0
    assert stats["ranks"] == [{"rank": 0, "cold_shapes": 0, "kernel_builds": 0},
                              {"rank": 1, "cold_shapes": 0, "kernel_builds": 0}]
    assert follower["cold_shapes"] == 0 == follower["kernel_builds"]
    assert follower["shapes"] == served["shapes"]
    assert served["warm_collectives"]["world broadcast"]["calls"] == 1
    assert served["warm_collectives"]["world all_gather"]["calls"] > 0


def test_reload_across_ranks_swaps_back_bit_equal(engine_runs):
    served = engine_runs["ranks"][0]
    assert served["w_new"].shape != served["solo"][0].shape or not np.array_equal(served["w_new"], served["solo"][0])
    np.testing.assert_array_equal(served["w_back"], served["solo"][0])


def test_engine_batch_must_divide_the_group(tiny_pair):
    task = build_inference_task(tiny_pair["am"])
    with pytest.raises(ValueError, match="divide"):
        BatchingEngine(task, sample_rate=SR, batch_size=3, group=mesh.Group("gloo", 0, 2, None, None))
    with pytest.raises(ValueError, match="divide"):
        task.use_mesh(mesh.Group("gloo", 0, 2, None, None)).predict(
            {"text": np.ones((3, 4, 2), np.int32), "text_length": np.full(3, 4, np.int32)})


def test_a_failing_follower_fails_the_batch_and_never_hangs(tiny_pair):
    """The follower raises before its first collective: rank 0's request
    fails when the group's 15 s timeout ends, later ones at once, and stop
    still ends the follower (the run returns)."""
    out = _ranks(workers.failing_follower_rank, tiny_pair["am"], TEXTS[0], group_timeout_s=15.0)[0]
    first, took = out["first"]
    assert first != "ok" and took < 60, out
    second, took2 = out["second"]
    assert "failed earlier" in second and took2 < 5, out
    assert out["stats"]["errors"] == 2 and out["stats"]["group_failed"].startswith("rank 0: RuntimeError")


def test_rank_devices_follow_the_launch_options():
    assert rank_devices(2, "cpu") == (["cpu", "cpu"], "gloo")
    assert rank_devices(2, "cuda", "0,0") == (["cuda:0", "cuda:0"], "gloo")
    assert rank_devices(2, "cuda", "0,1") == (["cuda:0", "cuda:1"], "nccl")
    assert rank_devices(0, "cuda", "0,0,1", "gloo") == (["cuda:0", "cuda:0", "cuda:1"], "gloo")
    with pytest.raises(ValueError, match="must be given"):
        rank_devices(-1, "cpu")
    with pytest.raises(ValueError, match="do not match"):
        rank_devices(3, "cuda", "0,1")


# ----------------------------------------------------------------- the CLIs


def _write(path, obj):
    with open(path, "w") as f:
        yaml.safe_dump(obj, f)
    return path


def test_infer_over_two_ranks_pads_the_last_batch(tiny_pair, tmp_path):
    """5 texts at -b 4: the last batch (1 text) is padded to 2 rows by
    repeating its last row; the files equal one process's."""
    cases = {f"u{i}": {"text": t} for i, t in enumerate(TEXTS + ["2_1 3_3 9_0", "7_2"])}
    test_list = _write(str(tmp_path / "t.yaml"), cases)
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    t_infer.main(["-m", tiny_pair["am"], "-t", test_list, "-o", one, "-b", "4", "--device", "cpu"])
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", "msmctts_tpu_torch.infer", "-m", tiny_pair["am"], "-t", test_list,
                          "-o", two, "-b", "4", "--device", "cpu", "--mesh-devices", "2"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "processed 5 utterances" in res.stdout and "2 rank(s)" in res.stdout
    assert sorted(os.listdir(one)) == sorted(os.listdir(two)) and len(os.listdir(one)) == 10  # wav + embedding
    from scipy.io import wavfile

    for f in os.listdir(one):
        if f.endswith(".wav"):
            a, b = wavfile.read(os.path.join(one, f))[1], wavfile.read(os.path.join(two, f))[1]
            assert a.shape == b.shape and a.size > 0
            np.testing.assert_allclose(b.astype(np.int32), a.astype(np.int32), atol=1)  # int16 PCM of 1e-6
        else:
            np.testing.assert_array_equal(np.load(os.path.join(two, f)), np.load(os.path.join(one, f)))


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, json.dumps(body) if body is not None else None, {"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, r.read()


def test_daemon_over_two_ranks_answers_a_request_and_a_stream(tiny_pair):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.Popen([sys.executable, "-m", "msmctts_tpu_torch.serve", "-m", tiny_pair["am"], "--device", "cpu",
                             "--mesh-devices", "2", "--port", "0", "--batch-size", "2", "--max-frames", "64",
                             "--warmup-lengths", "8", "--stream-chunk-frames", "8"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port, lines = None, []
        deadline = time.time() + 180
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving on http://"):
                port = int(line.strip().rsplit(":", 1)[1])
        assert port is not None, "".join(lines)[-3000:]
        assert any("ranks 2" in l for l in lines)
        status, data = _request(port, "POST", "/synthesize", {"text": TEXTS[0]})
        assert status == 200 and data[:4] == b"RIFF"
        pcm = np.frombuffer(data[44:], "<i2")
        status, stream = _request(port, "POST", "/synthesize", {"text": TEXTS[0], "stream": True})
        assert status == 200 and stream[:4] == b"RIFF"
        for _ in range(100):  # the streamed batch is counted once its worker call returns
            status, raw = _request(port, "GET", "/stats")
            stats = json.loads(raw)
            if stats["requests"] == 2:
                break
            time.sleep(0.05)
        assert stats["requests"] == 2 and stats["errors"] == 0 and stats["cold_shapes"] == 0
        assert [r["cold_shapes"] for r in stats["ranks"]] == [0, 0] and stats["kernel_builds"] == 0
        assert pcm.size > 0
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(60)
        finally:
            if proc.poll() is None:
                proc.kill()
