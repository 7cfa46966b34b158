"""queue_wait_ms_p95: the 95th percentile of the time a request waits in
the engine's queue, from its enqueue to the end of the gather that takes it
into a batch (the program's ``request.queue`` spans), over the requests
sent in the untraced rest of a traced run's window. Prints the 95th
percentile of the requests' whole time in the engine (``request``)."""

from perfbench import spans
from perfbench.core import percentile

LAYER = "serving.BatchingEngine"
UNIT = "ms"
MOVES = "latency_p95_ms"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]


def read(run):
    if run.untraced is None:
        return None
    tree = spans.read(*run.untraced)
    waits = sorted(s.t1 - s.t0 for s in tree.named("request.queue")) if tree is not None else []
    if not waits:
        return None
    whole = sorted(s.t1 - s.t0 for s in tree.named("request"))
    spans.log(f"requests in the engine: {len(whole)}, p95 {percentile(whole, 95) * 1e3:.1f} ms enqueue to delivery")
    return percentile(waits, 95) * 1e3
