"""graph_share.train: the share of the train steps of the untraced rest of
a traced run's window whose network calls ran as CUDA graphs (the
program's ``train.step`` spans with ``graphed`` 1), in percent. A program
whose steps do not say (no ``graphed`` on any step) gives nothing."""

from perfbench import spans

LAYER = "training/vqgan_trainer.py"
UNIT = "%"
MOVES = "step_ms"
WORKLOADS = ["csmsc_ae.gan_step_b16"]


def read(run):
    if run.untraced is None:
        return None
    tree = spans.read(*run.untraced)
    steps = [s for s in tree.named("train.step") if "graphed" in s.attrs] if tree is not None else []
    return sum(s.attrs["graphed"] == 1 for s in steps) / len(steps) * 100.0 if steps else None
