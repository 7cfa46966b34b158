"""Training CLI of the port, on the GPU.

    python -m msmctts_tpu_torch.train -c examples/csmsc/configs/msmc_vq_gan.yaml \\
        [--max-steps N] [--log-every N] [--device cpu]

The counterpart of the root ``train.py``: the same YAML recipes, the same
checkpoints. One process, one GPU. Runs on ``cuda`` unless ``--device cpu``
is given; without a GPU it refuses to run.
"""

from __future__ import annotations

import argparse

from msmctts_tpu_torch.config import Config, component_kwargs
from msmctts_tpu_torch.registry import get_trainer
from msmctts_tpu_torch.tasks import build_task


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--max-steps", type=int, default=None, help="stop after N steps")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    config = Config(args.config)
    task = build_task(config, device=args.device, mode="train")
    trainer = get_trainer(config.trainer["_name"])(config, task, **component_kwargs(config.trainer))
    trainer.train(max_steps=args.max_steps, log_every=args.log_every)
    return trainer


if __name__ == "__main__":
    main()
