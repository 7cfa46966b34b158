"""predict_idle_ms: the device's idle time a batch while the engine's
worker is inside ``MSMCTTS.predict`` (the program's ``predict`` spans,
placed on the trace's clock), the mean over the batches of the traced part
of the window. Prints the device's idle time in that part by the innermost
program span open on the host, and the share of it inside any span."""

from perfbench import spans

LAYER = "tasks.MSMCTTS.predict"
UNIT = "ms"
MOVES = "audio_s_per_s"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]


def read(run):
    if run.trace is None:
        return None
    tree = spans.read(run.start, run.end)
    calls = [p for p in tree.named("predict") if p.t1 <= run.end] if tree is not None else []
    if not calls:
        return None
    busy = run.trace.busy(*run.trace_window)
    idle = [(p.t1 - p.t0) - spans.overlap(busy, run.on_trace(p.t0), run.on_trace(p.t1)) for p in calls]
    by, total = spans.idle_by_span(run, tree)
    if total > 0:
        spans.log(f"device idle {total * 1e3:.1f} ms over {run.window_s:.2f} s traced, "
                  f"{sum(by.values()) / total * 100:.1f}% inside program spans; by innermost span (ms): "
                  + ", ".join(f"{n} {v * 1e3:.1f}" for n, v in sorted(by.items(), key=lambda kv: -kv[1])))
    return sum(idle) / len(idle) * 1e3
