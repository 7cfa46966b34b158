"""decoder_device_ms: device time per batch of everything launched inside
the HiFi-GAN ``Generator``'s forward (forward-hook range), from the trace."""

LAYER = "models/hifigan.py"
UNIT = "ms"
MOVES = "audio_s_per_s"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]


def read(run):
    if run.trace is None or not run.calls:
        return None
    t = run.device_time(["decoder"])
    return t / len(run.calls) * 1e3 if t > 0 else None
