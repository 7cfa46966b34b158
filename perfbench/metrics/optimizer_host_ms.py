"""optimizer_host_ms: the host's time a train step in its two optimizer
updates (the program's ``train.d_optimizer`` and ``train.g_optimizer``
spans), the mean over the steps of the untraced rest of a traced run's
window."""

from perfbench import spans

LAYER = "training/optim.py"
UNIT = "ms"
MOVES = "step_ms"
WORKLOADS = ["csmsc_ae.gan_step_b16"]


def read(run):
    if run.untraced is None:
        return None
    tree = spans.read(*run.untraced)
    steps = tree.named("train.step") if tree is not None else []
    return tree.mean_under(steps, ("train.d_optimizer", "train.g_optimizer")) if steps else None
