"""Batch offline inference over a test list (the counterpart of the root
``infer.py``):

    python -m msmctts_tpu_torch.infer -m <checkpoint> [-c config.yaml] \\
        -t testlist.yaml -o outdir [-b 1] [--static-frames N] [--int8] [--device cpu]

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
calibrated on the first batch.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np

from msmctts_tpu_torch.config import Config
from msmctts_tpu_torch.data.datasets import feature_normalize, save_wav
from msmctts_tpu_torch.data.loader import finite_loader
from msmctts_tpu_torch.tasks import build_task
from msmctts_tpu_torch.training.base_trainer import build_dataset_from_config
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint

# options of the JAX package's infer.py that the port does not have yet, and
# the ROADMAP item that brings each
NOT_PORTED = {
    "--debug": "debug_step is not ported (ROADMAP A7)",
    "--mesh-devices": "inference over a group from infer is not ported (ROADMAP A12c); use --mesh-devices 1",
}


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
    p.add_argument("--debug", action="store_true", help="not ported (ROADMAP A7)")
    p.add_argument("--int8", action="store_true",
                   help="int8 post-training-quantized HiFi-GAN decoder, calibrated on the first batch")
    p.add_argument("--mesh-devices", type=int, default=1, metavar="N", help="only 1 (ROADMAP A12c)")
    args = p.parse_args(argv)
    for flag, on in (("--debug", args.debug), ("--mesh-devices", args.mesh_devices != 1)):
        if on:
            p.error(NOT_PORTED[flag])

    ckpt = load_checkpoint(args.model)
    config = Config(args.config) if args.config else Config(ckpt["config"])
    out_dir = args.output or os.path.join(os.path.dirname(os.path.abspath(args.model)), f"eval-{ckpt['iteration']}")
    os.makedirs(out_dir, exist_ok=True)

    task = build_task(config, device=args.device)
    task.load_variables(ckpt["state"])
    if args.static_frames is not None:
        task.static_max_frames = args.static_frames
    task.int8_decoder = args.int8

    test_config = Config(config.to_dict())
    test_config["dataset"] = config.get("testset", config.dataset)
    dataset = build_dataset_from_config(test_config, training=False, id_list=args.test_list)
    save_features = config.get("save_features") or [["wav", ".wav", config.dataset["samplerate"]]]

    total, written = 0, 0
    for batch in finite_loader(dataset, args.batch_size):
        ids = batch.pop("_id", None)
        n = len(next(iter(batch.values())))
        output = task.infer_step(batch)
        total += n
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
    print(f"processed {total} utterances, {written} files -> {out_dir} ({task.device})")
    return out_dir


if __name__ == "__main__":
    main()
