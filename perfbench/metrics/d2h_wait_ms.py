"""d2h_wait_ms: the host's time a batch in ``MSMCTTS.predict``'s copies to
the host (the program's ``predict.d2h`` spans: each waits for the device's
work queued before it), the mean over the batches of the untraced rest of a
traced run's window. Prints the copies a batch and their bytes by what they
copy."""

from collections import Counter

from perfbench import spans

LAYER = "tasks.MSMCTTS.predict"
UNIT = "ms"
MOVES = "audio_s_per_s"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]


def read(run):
    if run.untraced is None:
        return None
    tree = spans.read(*run.untraced)
    calls = tree.named("predict") if tree is not None else []
    if not calls:
        return None
    copies, size, wait = Counter(), Counter(), Counter()
    for p in calls:
        for c in tree.under(p, ("predict.d2h",)):
            what = c.attrs["what"]
            copies[what] += 1
            size[what] += c.attrs["bytes"]
            wait[what] += c.t1 - c.t0
    n = len(calls)
    spans.log(f"d2h a batch over {n} batches: {sum(copies.values()) / n:.2f} copies; " + ", ".join(
        f"{w} {copies[w] / n:.2f} x {size[w] / copies[w]:.0f} B, {wait[w] / n * 1e3:.3f} ms" for w in copies))
    return sum(wait.values()) / n * 1e3
