"""kernel_launches.serve: kernels launched per batch, from the trace: the
kernels whose launch lies inside a task call of the window, over the calls."""

LAYER = "device"
UNIT = "launches"
MOVES = "audio_s_per_s"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]


def read(run):
    if run.trace is None or not run.calls:
        return None
    lo, hi = run.trace_window
    n = len(run.trace.kernels_in(["task_call"], lo, hi, cats=("kernel",)))
    return n / len(run.calls) if n else None
