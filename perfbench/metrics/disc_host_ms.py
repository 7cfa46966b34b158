"""disc_host_ms: the host's time a train step in the discriminators'
passes (the program's ``train.d_forward`` and ``train.g_disc_forward``
spans, the latter inside ``train.g_loss``), the mean over the steps of the
untraced rest of a traced run's window."""

from perfbench import spans

LAYER = "models/hifigan.py discriminators"
UNIT = "ms"
MOVES = "step_ms"
WORKLOADS = ["csmsc_ae.gan_step_b16"]


def read(run):
    if run.untraced is None:
        return None
    tree = spans.read(*run.untraced)
    steps = tree.named("train.step") if tree is not None else []
    return tree.mean_under(steps, ("train.d_forward", "train.g_disc_forward")) if steps else None
