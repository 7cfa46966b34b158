"""vq_stats_roofline: the least time of the codebook statistics calls
(nearest codewords, counts and sums of the valid rows, two a step) over
their device time, in percent. The device time is everything launched
inside the benchmark's ``vq_stats`` ranges, around
``models/quantizer.vq_nearest_stats_sharded``; the least time counts each
step's two calls at its batch's rows (``perfbench/counts/vqgan.py``)."""

import sys

from perfbench.counts import tts, vqgan

LAYER = "ops/vq.py -> csrc/vq_stats.cu"
UNIT = "%"
MOVES = "step_ms"
WORKLOADS = ["csmsc_ae.gan_step_b16"]


def read(run):
    if run.trace is None or not run.calls:
        return None
    device = run.device_time(["vq_stats"])
    if device <= 0:
        return None
    shapes, program = run.rec["shapes"], run.rec["program"]
    calls = []
    for _, _, i in run.calls:
        B, T, lengths = shapes[(i - 1) % len(shapes)]
        calls += vqgan.step_snaps(program, B, T, lengths)
    least = tts.bounds(calls)
    print(f"vq_stats_roofline: {least['ops_bound_calls']} statistics calls bound by operations, "
          f"{least['bytes_bound_calls']} by bytes", file=sys.stderr)
    return least["least_s"] / device * 100.0
