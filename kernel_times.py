#!/usr/bin/env python3
"""Time the port's CUDA kernels of one checkout, to compare two checkouts
on one card inside one job.

    python3 kernel_times.py --root DIR --out FILE.json

runs, in this process, phases 1-3 of ``DIR/chip_smoke.py`` on ``DIR``'s
package (every kernel against its plain version at its path's shapes, with
kernel, plain and library times), then, from ``chip_smoke``'s profiler call,
the device time per call of the two VQ functions, every kernel each call
launches counted: the snap at N = 512, 2048 (a predict's) and 256, 1024 (a
rank's of two), the statistics at N = 1600, 6400 (a train step's) and 800,
3200 (a rank's of two). Last, a sha256 digest of each output of
``vq_nearest_stats`` (idx, quant, counts, sums) at N = 1600 and 6400 on
inputs from fixed seeds, so that two trees show whether their statistics
agree bit for bit. It uses only names that every revision of
``chip_smoke.py`` has, so ``DIR`` may be an unpacked ``git archive`` of an
older commit. Give each tree its own process, and run them in turns (old,
new, new, old): a card's clocks and its host differ from job to job.
"""

import argparse
import hashlib
import importlib
import json
import os
import sys

CALLS = 20  # calls per profile


def _digests(cs, vq, torch):
    """sha256 of the bytes of each output of vq_nearest_stats, per N."""
    out = {}
    for seed, N in ((11, 1600), (12, 6400)):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x, e = cs._vq_case(gen, N)
        mask = (torch.rand(N, device="cuda", generator=gen) < 0.8).float()
        res = vq.vq_nearest_stats(x, e, mask)
        torch.cuda.synchronize()
        out[N] = {name: hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()
                  for name, t in zip(("idx", "quant", "counts", "sums"), res)}
    return out


def _per_call(profile):
    """Device ms and kernel launches per call of a profile of CALLS calls.
    Each kernel of these functions runs once per call, so a call takes the
    sum of their mean times (the tracer may drop a few launches)."""
    rows = profile["kernels"]
    return {"device_ms": sum(r["device_ms"] / r["count"] for r in rows),
            "launches": sum(r["count"] for r in rows) / CALLS,
            "by_kernel": {r["name"]: r["device_ms"] / r["count"] for r in rows}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout whose chip_smoke.py and package are timed")
    ap.add_argument("--out", required=True, help="JSON file for every measurement")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    out = os.path.abspath(args.out)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    cs = importlib.import_module("chip_smoke")
    vq = importlib.import_module("msmctts_tpu_torch.ops.vq")
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    env = cs.phase_environment()
    build = cs.phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"env": env, "build": build, "vq": cs.phase_vq(gen), "vq_stats": cs.phase_vq_stats(gen),
           "resblock": cs.phase_resblock(gen), "snap_device": {}, "stats_device": {}}
    for key, fn, sizes in (("snap_device", "snap", (512, 2048, 256, 1024)),
                           ("stats_device", "stats", (1600, 6400, 800, 3200))):
        for N in sizes:
            x, e = cs._vq_case(gen, N)
            mask = (torch.rand(N, device="cuda", generator=gen) < 0.8).float()

            def calls():
                for _ in range(CALLS):
                    if fn == "snap":
                        vq.vq_nearest(x, e)
                    else:
                        vq.vq_nearest_stats(x, e, mask)

            calls()
            per = _per_call(cs.profile_call(calls, f"[N={N}]", f"{CALLS} {fn} calls"))
            res[key][N] = per
            cs.log(f"[N={N}] {fn}: {per['device_ms']:.5f} ms on the device per call in {per['launches']:.2f} launches")
    res["stats_digests"] = _digests(cs, vq, torch)
    cs.log(f"stats digests {json.dumps(res['stats_digests'])}")
    cs.log(env["nvidia_smi"])
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
