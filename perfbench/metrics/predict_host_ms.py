"""predict_host_ms: the host's time a batch in ``MSMCTTS.predict`` outside
its copies to the host, which wait for the device: the program's
``predict`` span less its ``predict.d2h`` descendants, the mean over the
batches of the untraced rest of a traced run's window. With the card kept
busy this is the time the host takes to enqueue a batch's work."""

from perfbench import spans

LAYER = "tasks.MSMCTTS.predict"
UNIT = "ms"
MOVES = "audio_s_per_s"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]


def read(run):
    if run.untraced is None:
        return None
    tree = spans.read(*run.untraced)
    calls = tree.named("predict") if tree is not None else []
    if not calls:
        return None
    whole = sum(p.t1 - p.t0 for p in calls) / len(calls) * 1e3
    tasks = [t for t in (tree.ancestor(p, "engine.task") for p in calls) if t is not None and t.t0 >= tree.lo]
    if tasks:
        spans.log(f"predict {whole:.3f} ms a batch over {len(calls)} batches, inside engine.task "
                  f"{sum(t.t1 - t.t0 for t in tasks) / len(tasks) * 1e3:.3f} ms")
    return whole - tree.mean_under(calls, ("predict.d2h",))
