"""The program's own spans (``msmctts_tpu_torch/utils/tracing.py``), as
the per-layer readers take them: those that start inside a window of the
host's clock, with their children and ancestors, and the device's idle
time by the innermost span open on the host.

A checkout whose program records no spans gives None, and its readers then
give nothing.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

QUEUED = ("request", "request.queue")  # a request's life, not work of the thread that records it


class Spans:
    """The spans that start in [lo, hi), with the tree of all that were kept."""

    def __init__(self, kept: list, lo: float, hi: float):
        self.lo, self.hi = lo, hi
        self.all = kept
        self.by_id = {s.id: s for s in kept}
        self.kids: Dict[int, list] = defaultdict(list)
        for s in kept:
            if s.parent is not None:
                self.kids[s.parent].append(s)
        for kids in self.kids.values():
            kids.sort(key=lambda s: s.t0)
        self.inside = sorted((s for s in kept if lo <= s.t0 < hi), key=lambda s: s.t0)

    def named(self, name: str) -> list:
        return [s for s in self.inside if s.name == name]

    def under(self, span, names) -> list:
        """The descendants of ``span`` named one of ``names``."""
        out, todo = [], list(self.kids.get(span.id, []))
        while todo:
            s = todo.pop()
            if s.name in names:
                out.append(s)
            todo.extend(self.kids.get(s.id, []))
        return out

    def ancestor(self, span, name: str):
        s = self.by_id.get(span.parent)
        while s is not None and s.name != name:
            s = self.by_id.get(s.parent)
        return s

    def depth(self, span) -> int:
        d, s = 0, self.by_id.get(span.parent)
        while s is not None:
            d, s = d + 1, self.by_id.get(s.parent)
        return d

    def mean_under(self, parents: list, names) -> Optional[float]:
        """The mean over ``parents`` of the time of their descendants named
        one of ``names``, in ms."""
        if not parents:
            return None
        return sum(c.t1 - c.t0 for p in parents for c in self.under(p, names)) / len(parents) * 1e3


def read(lo: float, hi: float) -> Optional[Spans]:
    """The program's spans that start in [lo, hi) (None where the program
    records none). Where the buffer was full, the window starts at the end
    of the oldest span kept: nothing that starts after it was dropped."""
    try:
        from msmctts_tpu_torch.utils import tracing
    except ImportError:
        return None
    kept = tracing.spans()
    if len(kept) >= tracing.CAPACITY:
        lo = max(lo, kept[0].t1)
    return Spans(kept, lo, hi)


def overlap(intervals: List[Tuple[float, float]], a: float, b: float) -> float:
    """The length of [a, b] that sorted, disjoint ``intervals`` cover."""
    i = max(bisect.bisect_right(intervals, (a, float("inf"))) - 1, 0)
    total = 0.0
    while i < len(intervals) and intervals[i][0] < b:
        total += max(0.0, min(b, intervals[i][1]) - max(a, intervals[i][0]))
        i += 1
    return total


def innermost(labelled: List[Tuple[float, float, int, str]]) -> List[Tuple[float, float, str]]:
    """Elementary pieces of time, each with the name of the deepest of the
    (start, end, depth, name) spans open over it."""
    points = sorted({p for a, b, _, _ in labelled for p in (a, b)})
    starts = sorted(labelled)
    active, i, pieces = [], 0, []
    for x0, x1 in zip(points, points[1:]):
        while i < len(starts) and starts[i][0] <= x0:
            active.append(starts[i])
            i += 1
        active = [s for s in active if s[1] > x0]
        if active:
            pieces.append((x0, x1, max(active, key=lambda s: s[2])[3]))
    return pieces


def idle_by_span(run, tree: Spans) -> Tuple[Dict[str, float], float]:
    """The device's idle time in the traced window by the innermost program
    span open on the host (requests' own spans left out), and the idle time
    in all, in seconds on the trace's clock."""
    lo, hi = run.trace_window
    busy = run.trace.busy(lo, hi)
    gaps, prev = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    labelled = [(run.on_trace(s.t0), run.on_trace(s.t1), tree.depth(s), s.name) for s in tree.all
                if s.name not in QUEUED and run.on_trace(s.t1) > lo and run.on_trace(s.t0) < hi]
    pieces = innermost(labelled)
    by: Dict[str, float] = defaultdict(float)
    j = 0
    for g0, g1 in gaps:
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            by[pieces[k][2]] += min(g1, pieces[k][1]) - max(g0, pieces[k][0])
            k += 1
    return dict(by), sum(b - a for a, b in gaps)


def log(text: str) -> None:
    print(text, file=sys.stderr, flush=True)
