"""ae_forward_host_ms: the host's time a train step in the autoencoder's
forward (the program's ``train.ae_forward`` span), the mean over the steps
of the untraced rest of a traced run's window. Prints every phase of a step
(the children of ``train.step``) and the share of the step they cover."""

from perfbench import spans

LAYER = "models/msmc_vqgan.py"
UNIT = "ms"
MOVES = "step_ms"
WORKLOADS = ["csmsc_ae.gan_step_b16"]


def read(run):
    if run.untraced is None:
        return None
    tree = spans.read(*run.untraced)
    steps = tree.named("train.step") if tree is not None else []
    if not steps:
        return None
    phases = {}
    for s in steps:
        for c in tree.kids.get(s.id, []):
            phases[c.name] = phases.get(c.name, 0.0) + (c.t1 - c.t0)
    whole = sum(s.t1 - s.t0 for s in steps)
    spans.log(f"train step phases (ms a step over {len(steps)} steps): "
              + ", ".join(f"{n} {v / len(steps) * 1e3:.2f}" for n, v in phases.items())
              + f"; they cover {sum(phases.values()) / whole * 100:.2f}% of {whole / len(steps) * 1e3:.2f} ms")
    return tree.mean_under(steps, ("train.ae_forward",))
