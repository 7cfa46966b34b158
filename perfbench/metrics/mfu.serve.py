"""mfu.serve: the operations the requests completed in the untraced rest of
a traced run's window need, at their own phones and frames
(``perfbench/counts/tts.py``: one encoder pass, no padding), over its
seconds, over the H100's 495 TFLOP/s (TF32, dense), in percent. The rest of
the window, from the tracer's stop to the window's end, runs at the host's
untraced speed, which the traced part does not."""

from perfbench.counts import tts

LAYER = "whole step"
UNIT = "%"
MOVES = "audio_s_per_s"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]


def read(run):
    if run.untraced is None:
        return None
    lo, hi = run.untraced
    done = [(p, f) for p, f, t in run.rec.get("completed", []) if lo <= t <= hi]
    if not done:
        return None
    flops = sum(tts.request_flops(run.task, phones, frames) for phones, frames in done)
    return flops / (hi - lo) / tts.PEAK_FLOPS * 100.0
