"""Batch offline inference over a test list (the counterpart of the root
``infer.py``):

    python -m msmctts_tpu_torch.infer -m <checkpoint> [-c config.yaml] \\
        -t testlist.yaml -o outdir [-b 1] [--static-frames N] [--int8] [--debug] [--device cpu]

Loads the task from the checkpoint's embedded config (or ``-c``), builds the
test dataset (the config's ``testset``, else its ``dataset``) with
``training=False`` and its id list replaced by ``-t``, runs
``task.infer_step`` per batch, denormalizes every output that has a
``feature_stat``, and saves each feature named in the config's
``save_features`` as .wav / .npy / .txt / .dat, or .png heatmaps where
matplotlib is installed (skipped where it is not). The output directory
defaults to ``eval-<iteration>`` beside the checkpoint. Runs on ``cuda``
unless ``--device cpu`` is given; without a GPU it refuses to run. ``--int8``
decodes with the int8 HiFi-GAN decoder (``ops/int8_generator.py``),
calibrated on the first batch. ``--debug`` runs ``task.debug_step`` in place
of ``infer_step``: in the autoencoder mode its outputs add each stage's
codeword ``indices`` and quantized ``embedding``, which ``save_features``
may name, as in the JAX package.

``--mesh-devices N`` runs the batches data-parallel over N ranks (the JAX
package's mesh, ``infer.py:95-98, 112-119``; N = 0 or -1: every local
card), one process a rank through ``parallel/launch.run_ranks``, with the
launch options ``--devices`` and ``--backend`` of ``train_dist``: a batch
that does not divide by N is padded by repeating its last row, every rank
computes its rows (``MSMCTTS.use_mesh``), and rank 0 alone writes the files.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np

from msmctts_tpu_torch.config import Config
from msmctts_tpu_torch.data.datasets import feature_normalize, save_wav
from msmctts_tpu_torch.data.loader import finite_loader
from msmctts_tpu_torch.parallel import mesh
from msmctts_tpu_torch.parallel.launch import rank_devices, run_ranks
from msmctts_tpu_torch.tasks import build_task
from msmctts_tpu_torch.training.base_trainer import build_dataset_from_config
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint


def save_feature(path_base: str, ext: str, feat, samplerate=None) -> bool:
    """Write one feature; returns False where it was skipped (.png without
    matplotlib)."""
    feat = np.asarray(feat)
    if ext == ".wav":
        save_wav(path_base + ext, feat, samplerate or 24000)
    elif ext == ".npy":
        np.save(path_base + ext, feat)
    elif ext == ".txt":
        np.savetxt(path_base + ext, feat)
    elif ext == ".png":
        if importlib.util.find_spec("matplotlib") is None:
            return False
        from msmctts_tpu_torch.utils.plot import plot_matrix

        plot_matrix(feat.T, path_base + ext)
    elif ext == ".dat":
        feat.astype(np.float32).tofile(path_base + ext)
    else:
        raise ValueError(f"unknown save extension {ext}")
    return True


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-c", "--config", default=None)
    p.add_argument("-t", "--test_list", required=True)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-b", "--batch_size", type=int, default=1)
    p.add_argument("--static-frames", type=int, default=None,
                   help="TTS: one fixed frame bucket, nothing read back before the waveform")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--debug", action="store_true", help="route batches through task.debug_step")
    p.add_argument("--int8", action="store_true",
                   help="int8 post-training-quantized HiFi-GAN decoder, calibrated on the first batch")
    p.add_argument("--mesh-devices", type=int, default=1, metavar="N",
                   help="data-parallel over N ranks, one process each (0 / -1: every local card)")
    p.add_argument("--devices", default=None, help="with --mesh-devices: CUDA indices, one per rank (0,0 shares card 0)")
    p.add_argument("--backend", default=None, help="with --mesh-devices: nccl | gloo (default: nccl, gloo on "
                                                    "the CPU or where ranks share a card)")
    args = p.parse_args(argv)
    if args.mesh_devices != 1:
        try:
            devices, backend = rank_devices(args.mesh_devices, args.device, args.devices, args.backend)
        except ValueError as e:
            p.error(str(e))
        return run_ranks(_infer_rank, len(devices), backend, devices, args, timeout_s=float("inf"))[0]
    return infer(args)


def _infer_rank(group, device, args) -> str:
    args.device = str(device)
    return infer(args, group)


def infer(args, group=None) -> str:
    """Run the test list (over ``group``'s ranks, rank 0 writing) and
    return the output directory."""
    W, writer = mesh.world(group), mesh.rank(group) == 0
    ckpt = load_checkpoint(args.model)
    config = Config(args.config) if args.config else Config(ckpt["config"])
    out_dir = args.output or os.path.join(os.path.dirname(os.path.abspath(args.model)), f"eval-{ckpt['iteration']}")
    if writer:
        os.makedirs(out_dir, exist_ok=True)

    task = build_task(config, device=args.device)
    task.load_variables(ckpt["state"])
    if args.static_frames is not None:
        task.static_max_frames = args.static_frames
    task.int8_decoder = args.int8
    if W > 1:
        task.use_mesh(group)

    test_config = Config(config.to_dict())
    test_config["dataset"] = config.get("testset", config.dataset)
    dataset = build_dataset_from_config(test_config, training=False, id_list=args.test_list)
    save_features = config.get("save_features") or [["wav", ".wav", config.dataset["samplerate"]]]

    step_fn = task.debug_step if args.debug else task.infer_step
    total, written = 0, 0
    for batch in finite_loader(dataset, args.batch_size):
        ids = batch.pop("_id", None)
        n = len(next(iter(batch.values())))
        if n % W:  # the last batch: repeat its last row (the JAX package's infer.py:114-118)
            batch = {k: np.concatenate([v] + [v[-1:]] * (W - n % W)) for k, v in batch.items()}
        output = step_fn(batch)
        total += n
        if not writer:
            continue
        for j in range(n):
            case = dataset.id_list[int(ids[j])] if ids is not None else (str(j),)
            case_name = case[0] if isinstance(case, (tuple, list)) else str(case)
            for entry in save_features:
                name, ext, sr = entry[0], entry[1], (entry[2] if len(entry) > 2 else None)
                if name not in output:
                    continue
                feat = np.asarray(output[name][j])
                if name in dataset.feature_stat:
                    feat = feature_normalize(feat, dataset.feature_stat[name], denormalize=True)
                written += save_feature(os.path.join(out_dir, f"{case_name}_{name}"), ext, feat, sr)
    if writer:
        print(f"processed {total} utterances, {written} files -> {out_dir} ({task.device}, {W} rank(s))")
    return out_dir


if __name__ == "__main__":
    main()
