"""Strip a training checkpoint to what inference reads (counterpart of the
root ``tools/strip_checkpoint.py``):

    python -m msmctts_tpu_torch.tools.strip_checkpoint <ckpt> -o <out> \\
        [--drop discriminator ...] [--f16]

Keeps ``params`` minus the modules named by ``--drop`` (default the
discriminator), ``codebook`` and ``model_state``, with the embedded config and
the iteration, so the output still drives ``infer`` / ``serve`` /
``tools.as_mcd_sweep`` of either package. The input may be a pickle or an
orbax snapshot directory; the output is a pickle, as the JAX tool writes. Everything else a trainer stored
goes: the JAX trainer's optax state, the port trainer's ``torch_opt_state``
and ``torch_rng``. Leaves are written as they were stored (a float16 input
stays float16); ``--f16`` casts float32 leaves to float16, which halves the
bytes at ~1e-3 relative rounding: fine for inference fixtures, not for
resuming training. Needs neither jax nor a GPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from msmctts_tpu_torch.utils.checkpoint import map_leaves, read_checkpoint, save_checkpoint


def _bytes(path: str) -> int:
    """A file's size, or the sum over a snapshot directory's files."""
    if not os.path.isdir(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def strip(state: dict, drop=("discriminator",), f16: bool = False) -> dict:
    """The inference part of a checkpoint's state tree."""
    slim = {"params": {k: v for k, v in state["params"].items() if k not in drop}}
    if "codebook" in state:
        slim["codebook"] = state["codebook"]
    if state.get("model_state"):
        slim["model_state"] = state["model_state"]
    if f16:
        slim = map_leaves(slim, lambda x: x.astype(np.float16)
                          if isinstance(x, np.ndarray) and x.dtype == np.float32 else x)
    return slim


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt")
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--drop", nargs="*", default=["discriminator"], help="top-level param modules to drop (train-only)")
    ap.add_argument("--f16", action="store_true",
                    help="store float leaves as float16 (halves bytes; ~1e-3 rel rounding: fine for inference, "
                         "not for resuming training)")
    args = ap.parse_args(argv)

    ckpt = read_checkpoint(args.ckpt)
    save_checkpoint(args.out, strip(ckpt["state"], args.drop, args.f16), ckpt["iteration"], ckpt["config"])
    print(f"{args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB (from {_bytes(args.ckpt) / 1e6:.1f} MB)")
    return args.out


if __name__ == "__main__":
    main()
