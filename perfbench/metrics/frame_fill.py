"""frame_fill: the share of the frames a served batch decodes that belong
to a request: the frame totals of the batch's real rows (``served_frames``
of the program's ``engine.deliver`` span) over its rows times its frame
bucket (``rows`` and ``frames`` of its ``predict`` span), summed over the
batches of the untraced rest of a traced run's window, in percent. Padded
rows and the frames past each utterance's end are the rest."""

from perfbench import spans

LAYER = "tasks.MSMCTTS.predict"
UNIT = "%"
MOVES = "audio_s_per_s"
WORKLOADS = ["csmsc_tts.serve_b16_c32"]


def read(run):
    if run.untraced is None:
        return None
    tree = spans.read(*run.untraced)
    if tree is None:
        return None
    served = {s.attrs["batch"]: s.attrs["served_frames"] for s in tree.all
              if s.name == "engine.deliver" and "served_frames" in s.attrs}
    useful = decoded = 0
    for p in tree.named("predict"):
        task = tree.ancestor(p, "engine.task")
        if task is not None and task.attrs["batch"] in served:
            useful += served[task.attrs["batch"]]
            decoded += p.attrs["rows"] * p.attrs["frames"]
    return useful / decoded * 100.0 if decoded else None
