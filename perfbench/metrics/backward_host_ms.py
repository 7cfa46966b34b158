"""backward_host_ms: the host's time a train step in its two backwards
(the program's ``train.d_backward`` and ``train.g_backward`` spans), the
mean over the steps of the untraced rest of a traced run's window."""

from perfbench import spans

LAYER = "training/vqgan_trainer.py"
UNIT = "ms"
MOVES = "step_ms"
WORKLOADS = ["csmsc_ae.gan_step_b16"]


def read(run):
    if run.untraced is None:
        return None
    tree = spans.read(*run.untraced)
    steps = tree.named("train.step") if tree is not None else []
    return tree.mean_under(steps, ("train.d_backward", "train.g_backward")) if steps else None
