"""The device trace of a ``--trace 1`` run and what per-layer metrics read
from it.

``torch.profiler`` records the CPU operators of the thread that starts it
(and CUDA activity of the whole process), so a driver starts and stops the
tracer on the thread that drives the device: for serving, the engine's
worker, from inside the benchmark's wrapper around the task call. Kineto is
initialised on the main thread first (:meth:`Tracer.prime`), as it must be.

The trace goes to a temporary directory under ``TMPDIR`` as Chrome JSON,
is read into a :class:`Trace` and deleted. The benchmark's own ranges
(``record_function("perfbench.<layer>")``, put around the program's calls
from outside by :class:`Ranges`) mark layer calls on the host; a
kernel belongs to a layer when the host call that launched it (the CUDA
runtime event with the same correlation id) falls inside one of its ranges,
so a renamed or replaced kernel still counts.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "perfbench."


_MISSING = object()


class Ranges:
    """The benchmark's ``record_function`` ranges around the program's
    calls, put in from outside: forward pre-hooks and hooks on a module, or a
    wrapper in place of an attribute (a bound method of one instance, or a
    function of a module, which its own module looks up at each call). A
    range opens only while ``active``; ``calls`` keeps the call shapes that
    a reader needs. :meth:`close` takes every hook and wrapper away."""

    def __init__(self):
        self.calls: Dict[str, List[tuple]] = {}
        self.active = False
        self._open: List = []
        self._undo: List = []

    def enter(self, name: str, shape=None) -> None:
        if not self.active:
            return
        import torch

        rf = torch.autograd.profiler.record_function(PREFIX + name)
        rf.__enter__()
        self._open.append(rf)
        if shape is not None:
            self.calls.setdefault(name, []).append((time.perf_counter(), shape))

    def exit(self) -> None:
        if self._open:
            self._open.pop().__exit__(None, None, None)

    def around(self, obj, attr: str, name: str) -> None:
        """A range around every call of ``obj.<attr>``, where it exists."""
        fn = getattr(obj, attr, None)
        if fn is None:
            return
        own = vars(obj).get(attr, _MISSING)

        def wrapped(*args, **kwargs):
            self.enter(name)
            try:
                return fn(*args, **kwargs)
            finally:
                self.exit()

        setattr(obj, attr, wrapped)
        self._undo.append(lambda: delattr(obj, attr) if own is _MISSING else setattr(obj, attr, own))

    def module(self, module, name: str, shape_of=None) -> None:
        """A range around every forward of ``module``; ``shape_of`` maps its
        first input to the shape kept in ``calls``."""
        pre = module.register_forward_pre_hook(
            lambda m, args: self.enter(name, None if shape_of is None else shape_of(args[0])))
        post = module.register_forward_hook(lambda m, args, out: self.exit())
        self._undo += [pre.remove, post.remove]

    def close(self) -> None:
        self.active = False
        while self._open:
            self.exit()
        while self._undo:
            self._undo.pop()()


class Tracer:
    """One profiler session, started and stopped on the thread that drives
    the device."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = None
        self.trace: Optional[Trace] = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        return profile(activities=acts, record_shapes=False, with_stack=False, profile_memory=False)

    def prime(self) -> None:
        """Initialise the profiler on the main thread."""
        with self._profile():
            pass

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()
        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix="perfbench-trace-")
        try:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            size = os.path.getsize(path)
            with open(path) as f:
                self.trace = Trace(json.load(f)["traceEvents"])
            print(f"trace: {size / 2**20:.1f} MiB, {len(self.trace.device)} device operations, "
                  f"{self.trace.launch_events} launch events, read in {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr, flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            self.prof = None


class Trace:
    """Device operations, launches and the benchmark's host ranges of one
    trace, times in seconds on the trace's clock."""

    def __init__(self, events: List[dict]):
        self.device: List[Tuple[str, float, float, Optional[int], str]] = []  # name, start, end, correlation, cat
        self.launch_at: Dict[int, float] = {}
        self.ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.launch_events = 0
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X" or cat is None:
                continue
            ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((e["name"], ts, ts + dur, corr, cat))
            elif cat in LAUNCH_CATS and corr is not None:
                self.launch_at[corr] = ts
                self.launch_events += 1
            elif cat == "user_annotation" and e["name"].startswith(PREFIX):
                self.ranges[e["name"][len(PREFIX):]].append((ts, ts + dur))
        self.device.sort(key=lambda d: d[1])
        for spans in self.ranges.values():
            spans.sort()

    def inside(self, name: str, t: float) -> bool:
        spans = self.ranges.get(name, [])
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= t <= spans[i][1]

    def kernels_in(self, names, lo: float, hi: float, cats=DEVICE_CATS):
        """Device operations of ``cats`` launched from inside any range of
        ``names`` (all of them where ``names`` is None) whose launch lies in
        [lo, hi]."""
        out = []
        for name, t0, t1, corr, cat in self.device:
            at = self.launch_at.get(corr, t0)
            if cat not in cats or not lo <= at <= hi:
                continue
            if names is None or any(self.inside(n, at) for n in names):
                out.append((name, t0, t1))
        return out

    def busy(self, lo: float, hi: float) -> List[Tuple[float, float]]:
        """The union of device operations' intervals, clipped to [lo, hi]."""
        merged: List[List[float]] = []
        for _, t0, t1, _, _ in self.device:
            t0, t1 = max(t0, lo), min(t1, hi)
            if t1 <= t0:
                continue
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        return [(a, b) for a, b in merged]

    def host_label(self, t: float, default: str) -> str:
        """The innermost benchmark range open at ``t`` (``default`` where none is)."""
        best, width = default, float("inf")
        for name, spans in self.ranges.items():
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1] and spans[i][1] - spans[i][0] < width:
                best, width = name, spans[i][1] - spans[i][0]
        return best

    def breakdown(self, lo: float, hi: float, idle_label: str, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing, in [lo, hi]."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, t0, t1, _, _ in self.device:
            t0, t1 = max(t0, lo), min(t1, hi)
            if t1 > t0:
                by_name[name] += t1 - t0
        busy = self.busy(lo, hi)
        gaps, prev = [], lo
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = b
        if hi > prev:
            gaps.append((prev, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        return {
            "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[self.host_label((a + b) / 2, idle_label), b - a] for a, b in gaps[:top]],
        }
