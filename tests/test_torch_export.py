"""The port's exported TTS artifacts (``export.py``, ``tools/export_tts.py``,
``serve --artifact``) against the port's task path and the JAX package's
``ExportedTTS``, on the CPU. Weights: the tiny AE + AM pair initialised in
JAX (``test_torch_slice.tiny_pair``).

Tolerances.
  * artifact vs the port's ``predict`` in ``static_max_frames`` mode:
    durations equal, wav 1e-6 (``tests/test_export.py``'s bound for JAX's
    artifact against JAX's task; the same operators on the same weights).
  * artifact vs JAX's artifact on the same inputs: durations equal, wav
    1e-4 (the predict tolerance of ``tests/test_torch_slice.py``).
  * ``--int8``: 1e-6 against the task's int8 ``predict`` (both calibrated
    on the same batch, the scales frozen into the artifact).
"""

import argparse
import http.client
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from msmctts_tpu.config import Config
from msmctts_tpu.export import ExportedTTS as JExportedTTS
from msmctts_tpu.export import save_artifacts as j_save_artifacts
from msmctts_tpu.tasks import build_task
from msmctts_tpu.utils.checkpoint import load_checkpoint
from msmctts_tpu_torch import serve as t_serve
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.export import ExportedTTS, save_artifacts
from msmctts_tpu_torch.serving import BatchingEngine
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.tools import export_tts as t_export_tool
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint as t_load_checkpoint
from tests.test_torch_slice import tiny_pair  # noqa: F401  (module fixture)
from tests.tiny import FRAMESHIFT

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, FRAMES, SR = 2, 64, 1600
WAV_TOL = 1e-6
JAX_TOL = 1e-4


def _port_task(am):
    ck = t_load_checkpoint(am)
    task = t_build_task(TConfig(ck["config"]), device="cpu")
    task.load_variables(ck["state"])
    task.pre_infer()
    return task


def _batch(lt=8):
    rng = np.random.default_rng(3)
    text = rng.integers(1, 5, size=(B, lt, 2)).astype(np.int32)
    text_length = np.asarray([lt, lt - 3], np.int32)
    return text, text_length


def _static_predict(task, text, text_length):
    task.static_max_frames = FRAMES
    try:
        return task.predict({"text": text, "text_length": text_length})
    finally:
        task.static_max_frames = None


@pytest.fixture(scope="module")
def exported(tiny_pair, tmp_path_factory):
    """The port's fp32 artifact at buckets 8 and 16 and the task it came from."""
    task = _port_task(tiny_pair["am"])
    out = str(tmp_path_factory.mktemp("torch_art"))
    manifest = save_artifacts(task, out, batch_size=B, text_lengths=[16, 8], max_frames=FRAMES, sample_rate=SR,
                              platforms=("cpu",))
    return {"task": task, "dir": out, "manifest": manifest}


def test_manifest_has_the_jax_keys(exported):
    with open(os.path.join(exported["dir"], "manifest.json")) as f:
        m = json.load(f)
    assert {"kind", "batch_size", "max_frames", "hop", "sample_rate", "n_streams", "platforms", "int8",
            "modules", "io"} <= set(m)
    assert (m["batch_size"], m["max_frames"], m["hop"], m["sample_rate"], m["n_streams"]) == (B, FRAMES, FRAMESHIFT,
                                                                                              SR, 2)
    assert m["platforms"] == ["cpu"] and m["int8"] is False and sorted(m["modules"]) == ["16", "8"]
    for files in m["modules"].values():
        assert os.path.exists(os.path.join(exported["dir"], files["cpu"]))


@pytest.mark.parametrize("lt", [8, 16])
def test_artifact_matches_the_static_frames_task_path(exported, lt):
    text, text_length = _batch(lt)
    art = ExportedTTS(exported["dir"], "cpu")
    wav, wav_length, mel_length = (t.numpy() for t in art.run(text, text_length))
    want = _static_predict(exported["task"], text, text_length)
    np.testing.assert_array_equal(mel_length, want["mel_length"])
    np.testing.assert_array_equal(wav_length, want["mel_length"] * FRAMESHIFT)
    assert wav.shape == (B, FRAMES * FRAMESHIFT) and mel_length.min() > 0
    for a, b in zip(art.synthesize(text, text_length), want["wav"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=WAV_TOL, rtol=0)


def test_artifact_matches_the_jax_artifact(exported, tiny_pair, tmp_path):
    text, text_length = _batch()
    with jax.default_matmul_precision("highest"):
        ck = load_checkpoint(tiny_pair["am"])
        jtask = build_task(Config(ck["config"]), mode="infer")
        jtask.load_variables(ck["state"])
        jtask.pre_infer()
        j_save_artifacts(jtask, str(tmp_path), batch_size=B, text_lengths=[8], max_frames=FRAMES, sample_rate=SR,
                         platforms=("cpu",))
        jart = JExportedTTS(str(tmp_path))
        want = jart._module(8).call(text, text_length)
    got = ExportedTTS(exported["dir"], "cpu").run(text, text_length)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=JAX_TOL, rtol=0)
    assert np.abs(np.asarray(want[0])).max() > 1e-2


def test_missing_bucket_and_streaming_are_refused(exported):
    art = ExportedTTS(exported["dir"], "cpu")
    assert art.buckets == [8, 16] and art.batch_size == B and art.n_streams == 2
    with pytest.raises(ValueError, match="no exported module for text length 12"):
        art.synthesize(np.zeros((B, 12, 2), np.int32), np.asarray([4, 4]))
    with pytest.raises(NotImplementedError, match="streaming"):
        art.predict_stream({})
    if not torch.cuda.is_available():  # the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ExportedTTS(exported["dir"])


def test_a_fresh_process_loads_the_artifact_without_the_models(exported):
    text, text_length = _batch()
    code = (
        "import sys, json, numpy as np\n"
        "from msmctts_tpu_torch.export import ExportedTTS\n"
        f"art = ExportedTTS({exported['dir']!r}, 'cpu')\n"
        f"wavs = art.synthesize(np.asarray({text.tolist()}, np.int32), np.asarray({text_length.tolist()}, np.int32))\n"
        "print(json.dumps({'lengths': [len(w) for w in wavs], 'sum': float(sum(w.sum() for w in wavs)),\n"
        "  'models': sorted(m for m in sys.modules if m.startswith('msmctts_tpu_torch.models')),\n"
        "  'jax': 'jax' in sys.modules, 'tasks': 'msmctts_tpu_torch.tasks' in sys.modules}))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    want = ExportedTTS(exported["dir"], "cpu").synthesize(text, text_length)
    assert line["models"] == [] and not line["jax"] and not line["tasks"]
    assert line["lengths"] == [len(w) for w in want]
    assert line["sum"] == pytest.approx(float(sum(w.sum() for w in want)), abs=1e-5)


@pytest.fixture(scope="module")
def int8_case(tiny_pair, tmp_path_factory):
    task = _port_task(tiny_pair["am"])
    text, text_length = _batch()
    task.int8_decoder = True
    want = _static_predict(task, text, text_length)  # the first call calibrates the scales
    out = str(tmp_path_factory.mktemp("torch_art8"))
    manifest = save_artifacts(task, out, batch_size=B, text_lengths=[8], max_frames=FRAMES, sample_rate=SR,
                              platforms=("cpu",), int8=True)
    return {"task": task, "dir": out, "manifest": manifest, "want": want, "batch": (text, text_length)}


def test_int8_artifact_matches_the_task_path(int8_case):
    assert int8_case["manifest"]["int8"] is True
    got = ExportedTTS(int8_case["dir"], "cpu").synthesize(*int8_case["batch"])
    for a, b in zip(got, int8_case["want"]["wav"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=WAV_TOL, rtol=0)
    # the programs' products are the int8 operator's
    import collections

    name = int8_case["manifest"]["modules"]["8"]["cpu"]
    ep = torch.export.load(os.path.join(int8_case["dir"], name))
    ops = collections.Counter(str(n.target) for n in ep.graph.nodes if "msmctts" in str(n.target))
    assert ops["msmctts.int8_conv1d.default"] > 0 and ops["msmctts.vq_nearest.default"] == 4
    assert ops["msmctts.fused_resblock_layer.default"] == 0


def test_int8_export_requires_calibration(tiny_pair, tmp_path):
    task = _port_task(tiny_pair["am"])
    task.int8_decoder = True
    with pytest.raises(ValueError, match="calibrat"):
        save_artifacts(task, str(tmp_path / "x"), batch_size=B, text_lengths=[8], max_frames=FRAMES, sample_rate=SR,
                       platforms=("cpu",), int8=True)


def test_fp32_programs_run_the_kernel_operators(exported):
    import collections

    ep = torch.export.load(os.path.join(exported["dir"], exported["manifest"]["modules"]["8"]["cpu"]))
    ops = collections.Counter(str(n.target) for n in ep.graph.nodes if "msmctts" in str(n.target))
    # 2 predictor snaps + 2 re-quantizations; 2 upsamples x 1 kernel size x 2 dilations
    assert ops == {"msmctts.vq_nearest.default": 4, "msmctts.fused_resblock_layer.default": 4}


def test_engine_serves_the_artifact(exported):
    """As ``tests/test_export.py::test_engine_serves_artifact``: the engine
    over the artifact gives the task's static-frames audio; streaming and
    reload are refused; warmup runs every bucket."""
    art = ExportedTTS(exported["dir"], "cpu")
    text = "3_1 5_2 7_0 2_1"
    eng = BatchingEngine(art, sample_rate=SR, batch_size=art.batch_size, window_ms=0.0, text_buckets=art.buckets)
    eng.start(warmup={})
    try:
        assert eng.warmup_s > 0 and eng._warm_shapes == {("exported", 8), ("exported", 16)}
        wav_art = eng.synthesize(text, timeout=300)
        long = eng.synthesize(" ".join(["3_1"] * 12), timeout=300)  # the 16 bucket
        with pytest.raises(RuntimeError, match="streaming"):
            list(eng.synthesize_stream(text, timeout=300))
        with pytest.raises(RuntimeError, match="immutable"):
            eng.reload({})
        with pytest.raises(ValueError, match="no exported module"):
            eng.synthesize(" ".join(["3_1"] * 17), timeout=300)
        assert eng.cold_shapes() == 0 and eng.kernel_builds() == 0
    finally:
        eng.stop()
    task = exported["task"]
    tok = np.asarray([[3, 1], [5, 2], [7, 0], [2, 1]], np.int32)
    text8 = np.zeros((B, 8, 2), np.int32)
    text8[:, :4] = tok
    want = _static_predict(task, text8, np.asarray([4, 4], np.int32))["wav"][0]
    np.testing.assert_allclose(wav_art, want, atol=WAV_TOL, rtol=0)
    assert long.shape[0] > 0


def test_serve_artifact_answers_in_process(exported, capsys):
    rc = t_serve.main(["--artifact", exported["dir"], "--device", "cpu", "--warmup-only"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["shapes"] == 2 and line["device"] == "cpu" and not line["streaming_warmed"]

    from http.server import ThreadingHTTPServer

    args = argparse.Namespace(artifact=exported["dir"], device="cpu", sample_rate=None, window_ms=2.0,
                              max_queue=16)
    eng = t_serve.build_engine(args).start(warmup={})
    ready = threading.Event()
    ready.set()
    server = ThreadingHTTPServer(("127.0.0.1", 0), t_serve.make_handler(eng, ready, request_timeout=120))
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_port, timeout=120)
        conn.request("POST", "/synthesize", body=json.dumps({"text": "3_1 5_2 7_0", "format": "json"}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        assert resp.status == 200 and payload["sample_rate"] == SR and payload["duration_s"] > 0
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["cold_shapes"] == 0 and stats["kernel_builds"] == 0 and stats["errors"] == 0
        conn.close()
    finally:
        server.shutdown()
        srv.join(timeout=10)
        server.server_close()
        eng.stop()


@pytest.mark.parametrize("extra", [["-m", "x"], ["--int8"], ["--static-frames", "64"]],
                         ids=["model", "int8", "static-frames"])
def test_serve_artifact_refuses_what_the_export_fixed(exported, capsys, extra):
    with pytest.raises(SystemExit) as e:
        t_serve.main(["--artifact", exported["dir"], "--device", "cpu", *extra])
    assert e.value.code != 0 and "--artifact" in capsys.readouterr().err


def test_export_tool_with_selftest(tiny_pair, tmp_path, capsys):
    out = str(tmp_path / "tool")
    t_export_tool.main(["-m", tiny_pair["am"], "-o", out, "--batch-size", "2", "--text-buckets", "8",
                        "--frames", str(FRAMES), "--platforms", "cpu", "--device", "cpu", "--int8",
                        "--selftest", "3_1 5_2 7_0 2_1"])
    text = capsys.readouterr().out
    assert "exported 1 programs" in text and "selftest ok" in text
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f)["int8"] is True
