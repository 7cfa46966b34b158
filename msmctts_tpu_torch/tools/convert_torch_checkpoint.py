"""Convert a reference (PyTorch MSMC-TTS) training checkpoint into a
``msmctts_tpu/v1`` snapshot (counterpart of the root
``tools/convert_torch_checkpoint.py``):

    python -m msmctts_tpu_torch.tools.convert_torch_checkpoint \\
        --torch <reference model_N> --config examples/csmsc/configs/msmc_vq_gan.yaml \\
        --out checkpoints/msmc_vq_gan/model_N [--iteration N]

The reference saves ``{'model': task.state_dict(), 'optimizer': ...,
'iteration': N, 'config': ...}``, with a prefix per module of the task
(``autoencoder.*``, ``predictor.*``, ``discriminator.*``). The port's modules
keep the reference's parameter names, so the tool maps them through
``weights.py``'s ``*_to_jax`` side, once each stage's per-head codebook
buffers (``quantizers.<h>.embed``, or one head's ``embed`` [d, K]) are
stacked into the port's one [H, d, K] tensor. The snapshot embeds the given
YAML config and loads in ``infer -m`` / ``train`` (restore, pretrain) of
either package.

The discriminator is not converted (inference never needs it, and a resumed
GAN phase re-estimates it quickly); no optimizer state is carried over. A
quantizer with ``norm: True`` carries its BatchNorm statistics
(``preprocessor.<i>.3.running_mean`` / ``running_var``) into
``model_state.batch_stats``, and learned upsamplers (``transposed_conv.<i>``)
into the params, as the JAX tool does. Needs neither jax nor a GPU.
"""

from __future__ import annotations

import argparse
import re

import numpy as np
import torch

from msmctts_tpu_torch.config import Config
from msmctts_tpu_torch.utils.checkpoint import save_checkpoint
from msmctts_tpu_torch.weights import msmc_vqgan_to_jax, multi_stage_predictor_to_jax

CODEBOOK = ("embed", "cluster_size", "embed_avg")
# a codebook buffer of one head: embed / embed_avg [d, K], cluster_size [K]
HEAD_NDIM = {"embed": 2, "cluster_size": 1, "embed_avg": 2}


def stack_codebook_heads(sd: dict) -> dict:
    """Reference codebook buffers -> the port's: ``<stage>.quantizers.<h>.<name>``
    (``MultiHeadQuantize``) stacked over h, and a single head's
    ``<stage>.<name>`` (``Quantize``) given its head axis. Already stacked
    buffers pass as they are."""
    out, heads = {}, {}
    for k, v in sd.items():
        m = re.fullmatch(r"(.*\.quantizer\.quantizer\.\d+)\.quantizers\.(\d+)\.(\w+)", k)
        if m and m[3] in CODEBOOK:
            heads.setdefault((m[1], m[3]), {})[int(m[2])] = v
            continue
        m = re.fullmatch(r".*\.quantizer\.quantizer\.\d+\.(\w+)", k)
        out[k] = v[None] if m and m[1] in CODEBOOK and v.ndim == HEAD_NDIM[m[1]] else v
    for (stage, name), by_head in heads.items():
        out[f"{stage}.{name}"] = np.stack([by_head[h] for h in sorted(by_head)])
    return out


def convert(sd: dict) -> dict:
    """Numpy state dict of a whole task -> {'params': ..., 'codebook': ...
    [, 'model_state': {'batch_stats': ...}]}."""
    state = {"params": {}}
    if any(k.startswith("autoencoder.") for k in sd):
        v = msmc_vqgan_to_jax(stack_codebook_heads(sd), "autoencoder")
        state["params"]["autoencoder"] = v["params"]
        state["codebook"] = v["codebook"]
        if v["batch_stats"]:  # quantizer norm: True running stats
            state["model_state"] = {"batch_stats": v["batch_stats"]}
    if any(k.startswith("predictor.") for k in sd):
        state["params"]["predictor"] = multi_stage_predictor_to_jax(sd, "predictor")
    skipped = sorted({k.split(".", 1)[0] for k in sd} - {"autoencoder", "predictor"})
    if skipped:
        print(f"note: skipping non-convertible modules: {', '.join(skipped)}")
    if not state["params"]:
        raise SystemExit("no convertible modules found in the checkpoint")
    return state


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--torch", required=True, dest="torch_path", help="reference checkpoint (torch.save format)")
    p.add_argument("--config", required=True,
                   help="YAML to embed (must describe the same architecture, e.g. the matching examples/ recipe)")
    p.add_argument("--out", required=True, help="output snapshot path")
    p.add_argument("--iteration", type=int, default=None, help="override the recorded iteration")
    args = p.parse_args(argv)

    ckpt = torch.load(args.torch_path, map_location="cpu", weights_only=False)
    model_sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    state = convert({k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                     for k, v in model_sd.items()})
    iteration = args.iteration
    if iteration is None:
        iteration = int(ckpt.get("iteration", 0)) if isinstance(ckpt, dict) else 0
    save_checkpoint(args.out, state, iteration, Config(args.config).to_dict())
    print(f"wrote {args.out} (iteration {iteration}; modules: {', '.join(state['params'])})")
    return args.out


if __name__ == "__main__":
    main()
