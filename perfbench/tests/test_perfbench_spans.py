"""The readers of the program's spans (``perfbench/spans.py`` and the ten
metrics that read it) on synthetic spans, recorded into the program's own
buffer, and a synthetic run whose trace places them on its clock."""

import sys
import time
from types import SimpleNamespace

import pytest

import msmctts_tpu_torch.utils
from perfbench import core, spans
from perfbench.trace import PREFIX, Trace
from msmctts_tpu_torch.utils import tracing
from msmctts_tpu_torch.utils.tracing import record

SERVE = ["queue_wait_ms_p95", "gather_wait_ms", "frame_fill", "predict_host_ms", "d2h_wait_ms",
         "predict_idle_ms"]
TRAIN = ["ae_forward_host_ms", "disc_host_ms", "backward_host_ms", "optimizer_host_ms"]
OFFSET = 250.0  # trace clock minus host clock
T0 = 1000.0  # the window's start on the host clock
BATCH = 0.1  # s a batch


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def _serve_spans(n=4):
    """n batches of 3 real rows in 4, each 100 ms: gather 2 ms, pad 1, a
    task call of 90 holding predict (88 ms: durations 6 with the totals'
    copy 2, features 30, decode 20, the wav copy 25 and the durations' 1),
    deliver 7 of 96 frames in 4 x 64; every request queued 50 + 10 j ms."""
    for k in range(n):
        t = T0 + k * BATCH
        record("engine.gather", t, t + 0.002, batch=k)
        record("engine.pad", t + 0.002, t + 0.003, batch=k)
        task = record("engine.task", t + 0.003, t + 0.093, batch=k, rows=3)
        p = record("predict", t + 0.004, t + 0.092, parent=task, rows=4, text=16, frames=64)
        d = record("predict.durations", t + 0.004, t + 0.010, parent=p)
        record("predict.d2h", t + 0.008, t + 0.010, parent=d, what="totals", bytes=32)
        record("predict.features", t + 0.010, t + 0.040, parent=p)
        record("predict.decode", t + 0.040, t + 0.060, parent=p)
        record("predict.d2h", t + 0.060, t + 0.085, parent=p, what="wav", bytes=4096)
        record("predict.d2h", t + 0.085, t + 0.086, parent=p, what="duration", bytes=256)
        record("engine.deliver", t + 0.093, t + 0.1, batch=k, served_frames=96)
        for j in range(3):
            r = record("request", t - 0.05 + 0.01 * j, t + 0.1, request=3 * k + j, batch=k)
            record("request.queue", t - 0.05 + 0.01 * j, t + 0.002, parent=r, request=3 * k + j, batch=k)


def _run(trace=None, n=4):
    """A traced run whose traced part and untraced rest both hold the n
    batches (the readers of either part see the same spans)."""
    window = (T0, T0 + n * BATCH)
    return SimpleNamespace(untraced=window, start=window[0], end=window[1], window_s=n * BATCH, trace=trace,
                           on_trace=lambda t: t + OFFSET, trace_window=(window[0] + OFFSET, window[1] + OFFSET))


def _trace(n=4):
    """The device busy from 10 to 80 ms of every batch; the benchmark's
    range around every task call, which places the host's clock."""
    events = []
    for k in range(n):
        t = (T0 + OFFSET + k * BATCH) * 1e6
        events.append({"ph": "X", "cat": "kernel", "name": "k", "ts": t + 10e3, "dur": 70e3,
                       "args": {"correlation": k}})
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": t + 9e3, "dur": 5,
                       "args": {"correlation": k}})
        events.append({"ph": "X", "cat": "user_annotation", "name": PREFIX + "task_call", "ts": t + 3e3,
                       "dur": 90e3})
    return Trace(events)


def _read(name, run):
    return core.metric(name).read(run)


def test_serve_readers_on_synthetic_spans(capsys):
    _serve_spans()
    run = _run(_trace())
    assert _read("gather_wait_ms", run) == pytest.approx(2.0)
    assert _read("frame_fill", run) == pytest.approx(96 / (4 * 64) * 100)
    assert _read("predict_host_ms", run) == pytest.approx(88.0 - 28.0)
    assert _read("d2h_wait_ms", run) == pytest.approx(28.0)
    waits = sorted([52.0, 42.0, 32.0] * 4)
    assert _read("queue_wait_ms_p95", run) == pytest.approx(core.percentile([w / 1e3 for w in waits], 95) * 1e3)
    assert _read("predict_idle_ms", run) == pytest.approx(88.0 - 70.0)
    err = capsys.readouterr().err
    assert "3.00 copies" in err and "totals 1.00 x 32 B" in err
    assert "cover 100.00% of the worker's wall" in err
    # idle a batch: 10 ms before the kernel (gather 2, pad 1, task 1, durations 4, the totals' copy 2)
    # and 20 after it (the wav copy 5, the durations' 1, predict 6, task 1, deliver 7)
    assert "100.0% inside program spans" in err and "predict.d2h 32.0" in err


def test_the_traced_readers_place_spans_by_the_runs_offset():
    _serve_spans(n=2)
    run = core.Run(SimpleNamespace(), {"window": (T0, T0 + 2 * BATCH), "spans": [(T0 + 0.003 + k * BATCH,)
                                                                                 for k in range(2)],
                                       "trace": _trace(n=2), "call_range": "task_call", "untraced": None})
    assert run.offset == pytest.approx(OFFSET)
    assert _read("predict_idle_ms", run) == pytest.approx(18.0)


def test_train_readers_on_synthetic_spans(capsys):
    phases = [("train.ae_forward", 30), ("train.d_forward", 20), ("train.d_backward", 40),
              ("train.d_optimizer", 5), ("train.g_loss", 50), ("train.g_backward", 80),
              ("train.g_optimizer", 15), ("train.metrics", 2)]
    for i in range(3):
        t = T0 + i * 0.25
        step = record("train.step", t, t + 0.245, iteration=i + 1)
        for name, ms in phases:
            sid = record(name, t, t + ms / 1e3, parent=step)
            if name == "train.ae_forward":
                record("quantizer.ema", t + 0.01, t + 0.011, parent=sid)
            if name == "train.g_loss":
                record("train.g_disc_forward", t + 0.01, t + 0.035, parent=sid)
            t += ms / 1e3
    run = _run(n=8)
    assert _read("ae_forward_host_ms", run) == pytest.approx(30.0)
    assert _read("disc_host_ms", run) == pytest.approx(20.0 + 25.0)
    assert _read("backward_host_ms", run) == pytest.approx(120.0)
    assert _read("optimizer_host_ms", run) == pytest.approx(20.0)
    assert "cover 98.78% of 245.00 ms" in capsys.readouterr().err


def test_spans_outside_the_window_are_left_out():
    _serve_spans(n=4)
    run = _run(n=2)  # the first two batches only
    assert _read("d2h_wait_ms", run) == pytest.approx(28.0)
    tree = spans.read(*run.untraced)
    assert len(tree.named("predict")) == 2


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_a_program_without_spans_gives_nothing(name, monkeypatch):
    """Over a checkout whose program records no spans (no tracing module),
    or a run with nothing in its window, a reader gives None and raises
    nothing."""
    run = _run(_trace())
    assert _read(name, run) is None  # an empty buffer
    _serve_spans()
    monkeypatch.delattr(msmctts_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "msmctts_tpu_torch.utils.tracing", None)  # importing it raises
    assert _read(name, run) is None
    assert _read(name, SimpleNamespace(untraced=None, trace=None)) is None


def test_idle_pieces_go_to_the_innermost_span():
    pieces = spans.innermost([(0.0, 10.0, 0, "outer"), (2.0, 4.0, 1, "inner"), (3.0, 3.5, 2, "leaf"),
                              (12.0, 13.0, 0, "next")])
    assert pieces == [(0.0, 2.0, "outer"), (2.0, 3.0, "inner"), (3.0, 3.5, "leaf"), (3.5, 4.0, "inner"),
                      (4.0, 10.0, "outer"), (12.0, 13.0, "next")]
    assert spans.overlap([(0.0, 1.0), (2.0, 3.0), (5.0, 9.0)], 0.5, 6.0) == pytest.approx(0.5 + 1.0 + 1.0)


def test_a_full_buffer_starts_the_window_after_the_oldest_span_kept():
    start = time.perf_counter()
    for i in range(tracing.CAPACITY):
        record("x", start + i, start + i + 0.5)
    tree = spans.read(start - 10.0, start + 10.0)
    assert tree.lo == start + 0.5 and [s.t0 for s in tree.inside] == [start + i for i in range(1, 10)]
