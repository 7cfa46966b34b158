"""Analysis-synthesis MCD over a checkpoint directory's snapshots
(counterpart of the root ``tools/as_mcd_sweep.py``):

    python -m msmctts_tpu_torch.tools.as_mcd_sweep --ckpt-dir <dir> -t test.yaml \\
        --ref-wav '<corpus>/wav/{}.wav' [-o sweep.json] [--snapshots 4000 8000 ...] [-b 2] \\
        [--int8 [--smooth-alpha 1.0] [--float-sites up_0 resblock_0_]] [--device cpu]

One task is built from the first snapshot's config and every ``model_<N>``
snapshot is loaded into it in turn (``MSMCTTS.load_variables``; under
``--int8`` each load drops the int8 decoder, which calibrates anew on its
first batch). Each utterance of the test list is decoded by
``analysis_synthesis`` (the card's VQ and MRF kernels, or the int8 decoder)
and scored against its reference wav: ``utils/audio.mcd`` between the
normalized log-mels of both (``melspectrogram`` at the corpus's sample
rate), on the host. The last line is the JAX tool's JSON line,
``{"metric": "as_mcd_db", ..., "snapshots": {N: mean dB}}``. Runs on
``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re

import numpy as np

from msmctts_tpu_torch.config import Config
from msmctts_tpu_torch.data.datasets import load_wav
from msmctts_tpu_torch.data.loader import finite_loader
from msmctts_tpu_torch.tasks import build_task
from msmctts_tpu_torch.training.base_trainer import build_dataset_from_config
from msmctts_tpu_torch.utils.audio import AudioConfig, mcd, melspectrogram
from msmctts_tpu_torch.utils.checkpoint import _is_complete_snapshot, load_checkpoint
from msmctts_tpu_torch.utils.device import resolve_device


def find_snapshots(ckpt_dir: str) -> dict:
    """iteration -> path of every ``model_<N>`` pickle or complete orbax
    snapshot directory in ``ckpt_dir`` (not ``*.tmp``, nor a directory whose
    ``state/`` is still being written)."""
    snaps = {}
    for path in glob.glob(os.path.join(ckpt_dir, "model_*")):
        m = re.fullmatch(r"model_(\d+)", os.path.basename(path))
        if m and _is_complete_snapshot(path):
            snaps[int(m.group(1))] = path
    return snaps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("-t", "--testlist", required=True)
    ap.add_argument("--ref-wav", required=True, help="ground-truth wav path pattern with {} for the id")
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("--snapshots", type=int, nargs="*", default=None,
                    help="iterations to evaluate (default: all model_* found)")
    ap.add_argument("-b", "--batch-size", type=int, default=2)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--smooth-alpha", type=float, default=1.0, help="SmoothQuant strength for --int8 (<0 disables)")
    ap.add_argument("--float-sites", nargs="*", default=[],
                    help="site-name prefixes kept in float under --int8 (e.g. up_0 resblock_0_)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)  # before any work: no silent CPU run
    snaps = find_snapshots(args.ckpt_dir)
    iters = sorted(args.snapshots or snaps)
    missing = [i for i in iters if i not in snaps]
    if missing:
        raise SystemExit(f"snapshots not found in {args.ckpt_dir}: {missing}")
    if not iters:
        raise SystemExit(f"no model_* snapshots in {args.ckpt_dir}")

    first = load_checkpoint(snaps[iters[0]])
    config = Config(first["config"])
    sr = int(config.dataset["samplerate"])
    acfg = AudioConfig(sample_rate=sr)
    task = build_task(config, device=device)
    if args.int8:
        task.int8_decoder = True
        task.int8_smooth_alpha = None if args.smooth_alpha < 0 else args.smooth_alpha
        task.int8_float_sites = tuple(args.float_sites)

    test_config = Config(config.to_dict())
    test_config["dataset"] = config.get("testset", config.dataset)
    dataset = build_dataset_from_config(test_config, training=False, id_list=args.testlist)
    ref_mels = {case[0]: melspectrogram(load_wav(args.ref_wav.format(case[0])), acfg) for case in dataset.id_list}

    results = {}
    for it in iters:
        task.load_variables(first["state"] if it == iters[0] else load_checkpoint(snaps[it])["state"])
        scores = []
        for batch in finite_loader(dataset, args.batch_size):
            ids = batch.pop("_id")
            for j, wav in enumerate(task.infer_step(batch)["wav"]):
                uid = dataset.id_list[int(ids[j])][0]
                scores.append(mcd(ref_mels[uid], melspectrogram(np.asarray(wav, np.float32), acfg)))
        results[it] = round(float(np.mean(scores)), 3)
        print(f"model_{it}: {results[it]:.3f} dB over {len(scores)} utts", flush=True)

    line = json.dumps({"metric": "as_mcd_db", "sample_rate": sr, "int8": args.int8,
                       "smooth_alpha": task.int8_smooth_alpha if args.int8 else None,
                       "float_sites": list(args.float_sites) or None, "snapshots": results})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return json.loads(line)


if __name__ == "__main__":
    main()
