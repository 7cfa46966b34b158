"""predict_ms: mean wall time of the task call per batch
(``MSMCTTS.predict`` through ``infer_step``, ending in the host copy of the
waveforms), from the benchmark's host span around the call."""

LAYER = "tasks.MSMCTTS.predict"
UNIT = "ms"
MOVES = "audio_s_per_s"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]


def read(run):
    if not run.calls:
        return None
    return sum(c[1] - c[0] for c in run.calls) / len(run.calls) * 1e3
