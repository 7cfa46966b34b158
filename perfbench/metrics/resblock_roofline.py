"""resblock_roofline: the least time of the MRF layers' calls over their
device time, in percent. Every MRF block's forward is a range (forward
hooks); its device time is everything launched inside it, and its least
time the sum over its layers of the larger of operations over 495 TFLOP/s
and bytes over 3.35 TB/s (``perfbench/counts/tts.py``)."""

import sys

from perfbench.counts import tts

LAYER = "ops/resblock.py -> csrc/resblock.cu"
UNIT = "%"
MOVES = "audio_s_per_s"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]


def read(run):
    if run.trace is None:
        return None
    calls = [shape for t, shape in run.rec["calls"].get("resblock", []) if run.start <= t < run.end]
    device = run.device_time(["resblock"])
    if not calls or device <= 0:
        return None
    least = tts.bounds([tts.resblock_layer(B, T, C, k) for B, T, C, k, n in calls for _ in range(n)])
    print(f"resblock_roofline: {least['ops_bound_calls']} MRF layer calls bound by operations, "
          f"{least['bytes_bound_calls']} by bytes", file=sys.stderr)
    return least["least_s"] / device * 100.0
