"""Export a trained TTS checkpoint as self-contained programs (counterpart of
the root ``tools/export_tts.py``):

    python -m msmctts_tpu_torch.tools.export_tts -m <am_ckpt> -o <dir> \\
        [--batch-size 8] [--text-buckets 32 64 128] [--frames 512] \\
        [--platforms cpu cuda] [--int8 --calibration-text PHONES] \\
        [--selftest PHONES] [--device cpu]

One ``torch.export`` program per (batch, text bucket) and platform, weights
embedded, and a ``manifest.json`` (``export.save_artifacts``); ``serve
--artifact <dir>`` and ``export.ExportedTTS`` run them with no model code.
``--int8`` freezes the int8 HiFi-GAN decoder into the programs, calibrated on
``--calibration-text`` (or the ``--selftest`` text) first. ``--selftest``
synthesizes its phone string through the artifact and through the task's
``predict`` at ``--frames`` static frames, and fails unless they agree. The
task runs on ``cuda`` unless ``--device cpu`` is given; a platform other
than the task's device is exported from a copy moved there.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from msmctts_tpu_torch.config import Config
from msmctts_tpu_torch.export import PLATFORMS, ExportedTTS, save_artifacts
from msmctts_tpu_torch.serving import parse_phone_string
from msmctts_tpu_torch.tasks import build_task
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint

SELFTEST_ATOL = 1e-5  # the root tool's


def _batch(tok: np.ndarray, batch_size: int, lt: int):
    """``tok`` in row 0 of a [B, lt] batch, the other rows one phone each."""
    text = np.zeros((batch_size, lt, tok.shape[1]), np.int32)
    text[0, : tok.shape[0]] = tok
    text[1:, 0] = tok[0]
    text_length = np.full((batch_size,), 1, np.int32)
    text_length[0] = tok.shape[0]
    return text, text_length


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-m", "--model", required=True, help="AM checkpoint")
    ap.add_argument("-c", "--config", default=None)
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--text-buckets", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--platforms", nargs="+", default=list(PLATFORMS), choices=PLATFORMS)
    ap.add_argument("--int8", action="store_true", help="freeze the int8 PTQ HiFi-GAN decoder into the artifact")
    ap.add_argument("--calibration-text", default=None, metavar="PHONES",
                    help="phone string that calibrates the int8 activation scales (default: the --selftest "
                         "text; one of the two is required with --int8)")
    ap.add_argument("--selftest", default=None, metavar="PHONES",
                    help="after export, synthesize this phone string through the artifact and the task path "
                         "and fail unless they match")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ckpt = load_checkpoint(args.model)
    config = Config(args.config) if args.config else Config(ckpt["config"])
    task = build_task(config, device=args.device)
    task.load_variables(ckpt["state"])
    task.pre_infer()
    lt_max = max(args.text_buckets)

    if args.int8:
        cal = args.calibration_text or args.selftest
        if not cal:
            sys.exit("--int8 needs --calibration-text (or --selftest)")
        text, text_length = _batch(parse_phone_string(cal), args.batch_size, lt_max)
        text_length[:] = text_length[0]
        text[1:] = text[0]
        task.int8_decoder = True
        task.static_max_frames = args.frames
        task.predict({"text": text, "text_length": text_length})  # calibrates the scales
        task.static_max_frames = None

    manifest = save_artifacts(task, args.out, args.batch_size, args.text_buckets, args.frames,
                              sample_rate=int(config.dataset["samplerate"]), platforms=args.platforms,
                              int8=args.int8)
    sizes = {n: os.path.getsize(os.path.join(args.out, n)) for n in manifest["export_s"]}
    print(f"exported {len(sizes)} programs to {args.out} ({sum(sizes.values()) / 1e6:.1f} MB; "
          + ", ".join(f"{n} {s:.1f}s" for n, s in manifest["export_s"].items()) + ")")

    if args.selftest:
        tok = parse_phone_string(args.selftest)
        lt = min((b for b in args.text_buckets if b >= tok.shape[0]), default=None)
        if lt is None:
            sys.exit(f"--selftest has {tok.shape[0]} phones, more than the largest bucket {lt_max}")
        text, text_length = _batch(tok, args.batch_size, lt)
        device = task.device.type if task.device.type in args.platforms else args.platforms[0]
        wav_art = ExportedTTS(args.out, device).synthesize(text, text_length)[0]
        task.static_max_frames = args.frames
        wav_task = np.asarray(task.predict({"text": text, "text_length": text_length})["wav"][0])
        np.testing.assert_allclose(wav_art, wav_task, atol=SELFTEST_ATOL)
        print(f"selftest ok: artifact == task path ({wav_art.shape[0]} samples, "
              f"max abs diff {float(np.max(np.abs(wav_art - wav_task))):.3g})")
    return manifest


if __name__ == "__main__":
    main()
