"""idle_share.train: the share of the traced window in which no operation
ran on the device, from the trace, in percent."""

LAYER = "device"
UNIT = "%"
MOVES = "step_ms"
WORKLOADS = ["csmsc_ae.gan_step_b16"]


def read(run):
    if run.trace is None or run.offset is None:
        return None
    busy = run.busy_s()
    return (1.0 - busy / run.window_s) * 100.0 if busy > 0 else None
