"""predict_ms_p95: the 95th percentile of the task call's wall time per
batch, the span of ``predict_ms``."""

from perfbench.core import percentile

LAYER = "tasks.MSMCTTS.predict"
UNIT = "ms"
MOVES = "latency_p95_ms"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]


def read(run):
    if not run.calls:
        return None
    return percentile(sorted(c[1] - c[0] for c in run.calls), 95) * 1e3
