"""engine_gap_ms: the engine worker's wall time per batch outside its call
into the task (gather window, padding, slicing the outputs into requests),
from the benchmark's host spans around ``task.infer_step``: the mean gap
between one call's end and the next call's start in the window."""

LAYER = "serving.BatchingEngine"
UNIT = "ms"
MOVES = "audio_s_per_s"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]


def read(run):
    calls = run.calls
    if len(calls) < 2:
        return None
    gaps = [b[0] - a[1] for a, b in zip(calls, calls[1:])]
    return sum(gaps) / len(gaps) * 1e3
