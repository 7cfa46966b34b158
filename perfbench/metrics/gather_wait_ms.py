"""gather_wait_ms: the engine worker's mean wait a batch for followers of
its first request in the gather window (the program's ``engine.gather``
spans), in the untraced rest of a traced run's window. Prints the worker's
loop a batch by span, the share of the worker's wall its spans cover, and
the worker's time between them by the span before."""

from perfbench import spans

LAYER = "serving.BatchingEngine"
UNIT = "ms"
MOVES = "latency_p95_ms"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]
LOOP = ("engine.wait", "engine.gather", "engine.pad", "engine.task", "engine.deliver")


def read(run):
    if run.untraced is None:
        return None
    tree = spans.read(*run.untraced)
    gathers = tree.named("engine.gather") if tree is not None else []
    if not gathers:
        return None
    lo, hi = tree.lo, tree.hi
    worker = gathers[0].thread
    own = sorted((s for s in tree.all if s.thread == worker and s.name in LOOP), key=lambda s: s.t0)
    cover = sum(max(0.0, min(hi, s.t1) - max(lo, s.t0)) for s in own) / (hi - lo)
    per = {n: sum(s.t1 - s.t0 for s in tree.named(n)) / len(gathers) * 1e3 for n in LOOP}
    between, longest = {}, 0.0
    for a, b in zip(own, own[1:]):
        gap = min(hi, b.t0) - max(lo, a.t1)
        if gap > 0:
            between[a.name] = between.get(a.name, 0.0) + gap
            longest = max(longest, gap)
    spans.log("engine loop a batch (ms): " + ", ".join(f"{n} {v:.3f}" for n, v in per.items())
              + f"; its spans cover {cover * 100:.2f}% of the worker's wall over {hi - lo:.1f} s; between them "
              + ", ".join(f"after {n} {v / len(gathers) * 1e3:.3f}" for n, v in between.items())
              + f" (longest {longest * 1e3:.1f})")
    return sum(s.t1 - s.t0 for s in gathers) / len(gathers) * 1e3
