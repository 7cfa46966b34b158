"""idle_share.serve: the share of the window in which no operation ran on
the device, from the trace, in percent."""

LAYER = "device"
UNIT = "%"
MOVES = "audio_s_per_s"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]


def read(run):
    if run.trace is None or run.offset is None:
        return None
    busy = run.busy_s()
    return (1.0 - busy / run.window_s) * 100.0 if busy > 0 else None
