"""predictor_device_ms: device time per batch of everything launched inside
``MultiStagePredictor``: its forward (forward-hook range) and its duration
pass (``predict_durations``), from the trace."""

LAYER = "models/predictor.py"
UNIT = "ms"
MOVES = "audio_s_per_s"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]


def read(run):
    if run.trace is None or not run.calls:
        return None
    t = run.device_time(["predictor", "durations"])
    return t / len(run.calls) * 1e3 if t > 0 else None
