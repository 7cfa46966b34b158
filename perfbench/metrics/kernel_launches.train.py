"""kernel_launches.train: kernels launched per train step, from the trace:
the kernels whose launch lies inside a step of the traced window, over the
steps."""

LAYER = "training/vqgan_trainer.py"
UNIT = "launches"
MOVES = "step_ms"
WORKLOADS = ["csmsc_ae.gan_step_b16"]


def read(run):
    if run.trace is None or not run.calls:
        return None
    lo, hi = run.trace_window
    n = len(run.trace.kernels_in(["step"], lo, hi, cats=("kernel",)))
    return n / len(run.calls) if n else None
