"""The port's spans (``msmctts_tpu_torch/utils/tracing.py``) on the CPU: the
recorder itself (parents across threads, the buffer's bound, ``record``,
the profiler's annotations only under a profiler, on one clock with the
spans), then the spans of one served request, one ``predict`` and one GAN
train step of the tiny recipes (the weights of ``test_torch_slice.tiny_pair``
and a port trainer of ``tiny.tiny_ae_config``)."""

import json
import threading

import pytest
import torch

from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.config import component_kwargs
from msmctts_tpu_torch.registry import get_trainer
from msmctts_tpu_torch.tasks import build_task
from msmctts_tpu_torch.utils import tracing
from msmctts_tpu_torch.utils.tracing import record, span
from tests.test_torch_serving import TEXTS, _batch, _engine, port_task  # noqa: F401  (module fixture)
from tests.test_torch_slice import tiny_pair  # noqa: F401  (module fixture)
from tests.tiny import FRAMESHIFT, MEL_DIM, tiny_ae_config

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _kids(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id), key=lambda s: s.t0)


# ------------------------------------------------------------------ recorder


def test_parents_nest_on_each_thread():
    barrier = threading.Barrier(2)

    def work(tag):
        with span("outer", tag=tag):
            barrier.wait(timeout=30)  # both threads hold an open span at once
            with span("inner", tag=tag):
                with span("leaf", tag=tag):
                    pass
            barrier.wait(timeout=30)

    threads = [threading.Thread(target=work, args=(tag,)) for tag in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    got = tracing.spans()
    assert len(got) == 6 and len({s.id for s in got}) == 6
    for tag in "ab":
        mine = {s.name: s for s in got if s.attrs["tag"] == tag}
        assert mine["outer"].parent is None
        assert mine["inner"].parent == mine["outer"].id
        assert mine["leaf"].parent == mine["inner"].id
        assert len({s.thread for s in mine.values()}) == 1
        assert mine["outer"].t0 <= mine["inner"].t0 <= mine["leaf"].t0 <= mine["leaf"].t1 <= mine["outer"].t1
    assert len({s.thread for s in got}) == 2


def test_the_buffer_keeps_the_newest():
    n = tracing.CAPACITY + 5
    for i in range(n):
        record("x", float(i), float(i) + 0.5, i=i)
    got = tracing.spans()
    assert len(got) == tracing.CAPACITY
    assert [got[0].attrs["i"], got[-1].attrs["i"]] == [5, n - 1]


def test_record_takes_its_times_and_parent():
    with span("open") as s:
        rid = record("request", 1.0, 3.0, request=7)
        qid = record("request.queue", 1.0, 2.0, parent=rid, request=7)
    got = {x.name: x for x in tracing.spans()}
    assert got["request"] == tracing.Span("request", rid, None, 1.0, 3.0, got["request"].thread, {"request": 7})
    assert (got["request.queue"].id, got["request.queue"].parent, got["request.queue"].t1) == (qid, rid, 2.0)
    assert got["open"].id == s.id and (s.t0, s.t1) == (got["open"].t0, got["open"].t1)


def test_no_profiler_annotation_without_a_profiler(monkeypatch):
    made = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function", lambda name: made.append(name))
    with span("quiet"):
        pass
    assert not made and [s.name for s in tracing.spans()] == ["quiet"]


def test_spans_lie_on_the_profilers_timeline(tmp_path):
    """Each span is an ``msmc.<name>`` annotation of the exported trace, at
    one offset from its own start (the two clocks differ by a constant)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("first"):  # the profiler's first annotation sets it up: its start is stamped early
            pass
        for i in range(4):
            with span(f"step{i}"):
                with span("mm"):
                    for _ in range(20):
                        x = torch.tanh(x @ x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and str(e.get("name", "")).startswith(tracing.PREFIX)]
    got = sorted(tracing.spans(), key=lambda s: s.t0)
    marks = sorted(events, key=lambda e: float(e["ts"]))
    assert [e["name"] for e in marks] == [tracing.PREFIX + s.name for s in got]
    marks, got = marks[1:], got[1:]
    offsets = [float(e["ts"]) * 1e-6 - s.t0 for e, s in zip(marks, got)]
    assert len(offsets) >= 3 and max(offsets) - min(offsets) < 2e-4
    for e, s in zip(marks, got):
        assert abs(float(e["dur"]) * 1e-6 - (s.t1 - s.t0)) < 2e-4


# ------------------------------------------------------------------ serving


def test_a_served_request_has_its_spans(port_task):  # noqa: F811
    eng = _engine(port_task, window_ms=0.0).start()
    try:
        eng.synthesize(TEXTS[0], timeout=120)
    finally:
        eng.stop()
    got = tracing.spans()
    names = _by_name(got)
    assert set(names) == {"engine.wait", "engine.gather", "engine.pad", "engine.task", "engine.deliver", "request",
                          "request.queue", "predict", "predict.durations", "predict.features", "predict.decode",
                          "predict.d2h"}
    (req,), (queued,) = names["request"], names["request.queue"]
    assert queued.parent == req.id and req.parent is None
    assert req.t0 == queued.t0 < queued.t1 <= req.t1
    assert req.attrs["request"] == queued.attrs["request"]
    batch = req.attrs["batch"]
    assert queued.attrs["batch"] == batch
    loop = [s for s in got if s.name.startswith("engine.") and s.attrs.get("batch") == batch]
    assert [s.name for s in sorted(loop, key=lambda s: s.t0)] == [
        "engine.wait", "engine.gather", "engine.pad", "engine.task", "engine.deliver"]
    task, deliver = names["engine.task"][0], names["engine.deliver"][0]
    assert task.attrs["rows"] == 1 and deliver.attrs["served_frames"] > 0
    (predict,) = names["predict"]
    assert predict.parent == task.id
    assert eng.stats.busy_seconds == task.t1 - task.t0
    assert "task_realtime_factor" in eng.snapshot() and "device_realtime_factor" not in eng.snapshot()


def test_predict_has_its_phases_and_one_span_a_copy(port_task):  # noqa: F811
    batch = _batch(forced=False)
    got = port_task.predict(batch)
    spans = tracing.spans()
    (predict,) = _by_name(spans)["predict"]
    B, Lt = batch["text"].shape[:2]
    assert (predict.attrs["rows"], predict.attrs["text"]) == (B, Lt)
    frames = predict.attrs["frames"]
    kids = _kids(spans, predict)
    assert [k.name for k in kids] == ["predict.durations", "predict.features", "predict.decode",
                                      "predict.d2h", "predict.d2h", "predict.d2h"]
    copies = {k.attrs["what"]: k for k in kids if k.name == "predict.d2h"}
    (totals,) = _kids(spans, kids[0])  # phase 1 reads the frame totals back to pick the bucket
    copies[totals.attrs["what"]] = totals
    assert sorted(copies) == ["duration", "embedding", "totals", "wav"]
    assert copies["totals"].attrs["bytes"] == B * 8
    assert copies["duration"].attrs["bytes"] == B * Lt * 4
    assert copies["wav"].attrs["bytes"] == B * frames * FRAMESHIFT * 4
    assert copies["embedding"].attrs["bytes"] == got["embedding"][0].shape[-1] * B * frames * 4
    assert len([s for s in spans if s.name == "predict.d2h"]) == 4


# ------------------------------------------------------------------ training


def test_a_train_step_has_its_phases_in_order(tmp_path):
    cfg = TConfig(tiny_ae_config(str(tmp_path)).to_dict())
    task = build_task(cfg, device="cpu", mode="train")
    trainer = get_trainer(cfg.trainer["_name"])(cfg, task, **component_kwargs(cfg.trainer))
    g = torch.Generator().manual_seed(0)
    B, T = 4, 32
    batch = {"mel": torch.randn((B, T, MEL_DIM), generator=g), "mel_length": torch.tensor([32, 28, 20, 16]),
             "wav": torch.randn((B, T * FRAMESHIFT), generator=g) * 0.1}
    starts = torch.tensor([3, 0, 5, 2])
    for it, phases in [(1, ["train.ae_forward", "train.g_loss", "train.g_backward", "train.g_optimizer"]),
                       (3, ["train.ae_forward", "train.d_forward", "train.d_backward", "train.d_optimizer",
                            "train.g_loss", "train.g_backward", "train.g_optimizer"])]:
        tracing.clear()
        trainer.train_step(batch, it, starts=starts)
        spans = tracing.spans()
        (step,) = _by_name(spans)["train.step"]
        assert step.attrs["iteration"] == it and step.parent is None
        kids = _kids(spans, step)
        assert [k.name for k in kids] == phases + ["train.metrics"]
        stages = len(cfg.task["autoencoder"]["encoder_config"]["downsample_scales"])
        for name in ("quantizer.stats", "quantizer.ema"):  # once a stage, inside the autoencoder's forward
            found = [x for x in spans if x.name == name]
            assert len(found) == stages and all(_under(spans, x, kids[0]) for x in found)
        if it == 3:
            (g_loss,) = [k for k in kids if k.name == "train.g_loss"]
            assert [s.name for s in _kids(spans, g_loss)] == ["train.g_disc_forward"]


def _under(spans, s, ancestor):
    by_id = {x.id: x for x in spans}
    p = by_id.get(s.parent)
    while p is not None and p.id != ancestor.id:
        p = by_id.get(p.parent)
    return p is not None
