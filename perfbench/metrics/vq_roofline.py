"""vq_roofline: the least time of the nearest-codeword snaps over their
device time, in percent. The device time is everything launched inside the
benchmark's ``snap`` ranges, around ``models/predictor.snap_with_codebook``
and each codebook's ``quantize`` (the re-quantization); the least time
counts, per batch, each stage's snap and its re-quantization at the batch's
rows and frame bucket (``perfbench/counts/tts.py``). Nothing is read where
no range holds a launch."""

import sys

from perfbench.counts import tts

LAYER = "ops/vq.py -> csrc/vq_nearest.cu"
UNIT = "%"
MOVES = "audio_s_per_s"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]


def read(run):
    if run.trace is None or not run.calls:
        return None
    device = run.device_time(["snap"])
    if device <= 0:
        return None
    calls = [c for t0, t1, B, F in run.calls for c in tts.predict_batch_snaps(run.task, B, F)]
    least = tts.bounds(calls)
    print(f"vq_roofline: {least['ops_bound_calls']} snap calls bound by operations, "
          f"{least['bytes_bound_calls']} by bytes", file=sys.stderr)
    return least["least_s"] / device * 100.0
