"""mfu.train: the forward and backward operations of the autoencoder and
both discriminators at each step's shapes (``perfbench/counts/vqgan.py``),
summed over the steps of the untraced rest of a traced run's window, over
its seconds, over the H100's 495 TFLOP/s (TF32, dense), in percent. The
profiler costs a step of 13k launches about its own length again, so the
traced steps are not counted."""

from perfbench.counts import tts, vqgan

LAYER = "whole step"
UNIT = "%"
MOVES = "step_ms"
WORKLOADS = ["csmsc_ae.gan_step_b16"]


def read(run):
    if run.untraced is None:
        return None
    lo, hi = run.untraced
    shapes, program = run.rec["shapes"], run.rec["program"]
    steps = [i for t0, _, i in run.rec["spans"] if t0 >= lo]
    if not steps:
        return None
    flops = sum(vqgan.step_flops(program, *shapes[(i - 1) % len(shapes)][:2]) for i in steps)
    return flops / (hi - lo) / tts.PEAK_FLOPS * 100.0
