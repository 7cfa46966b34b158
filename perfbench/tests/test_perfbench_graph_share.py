"""``graph_share.train`` on synthetic ``train.step`` spans recorded into
the program's own buffer, as ``test_perfbench_spans.py`` tests the other
span readers."""

import sys
from types import SimpleNamespace

import pytest

import msmctts_tpu_torch.utils
from perfbench import core
from msmctts_tpu_torch.utils import tracing
from msmctts_tpu_torch.utils.tracing import record

T0 = 1000.0  # the window's start on the host clock


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def _run(steps=4):
    return SimpleNamespace(untraced=(T0, T0 + steps * 0.25), trace=None)


def _read(run):
    return core.metric("graph_share.train").read(run)


def test_the_share_of_steps_that_ran_as_graphs():
    for i, graphed in enumerate([1, 1, 0, 1]):
        record("train.step", T0 + i * 0.25, T0 + i * 0.25 + 0.2, iteration=i + 1, graphed=graphed)
    record("train.step", T0 - 1.0, T0 - 0.8, iteration=0, graphed=0)  # before the window
    assert _read(_run()) == pytest.approx(75.0)


def test_steps_that_do_not_say_give_nothing(monkeypatch):
    """A program whose steps carry no ``graphed``, a program without spans
    and a run without an untraced rest give None and raise nothing."""
    for i in range(4):
        record("train.step", T0 + i * 0.25, T0 + i * 0.25 + 0.2, iteration=i + 1)
    assert _read(_run()) is None
    assert _read(SimpleNamespace(untraced=None, trace=None)) is None
    monkeypatch.delattr(msmctts_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "msmctts_tpu_torch.utils.tracing", None)  # importing it raises
    assert _read(_run()) is None
