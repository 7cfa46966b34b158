#!/usr/bin/env python3
"""Time the port's CUDA kernels of one checkout, to compare two checkouts
on one card inside one job.

    python3 kernel_times.py --root DIR --out FILE.json

runs, in this process, phases 1-3 of ``DIR/chip_smoke.py`` on ``DIR``'s
package (every kernel against its plain version at its path's shapes, with
kernel, plain and library times) and then the device time per launch of the
two VQ kernels at N = 512, 2048, 1600 and 6400 from ``chip_smoke``'s
profiler call. It uses only names that every revision of ``chip_smoke.py``
has, so ``DIR`` may be an unpacked ``git archive`` of an older commit. Give
each tree its own process, and run them in turns (old, new, new, old): a
card's clocks and its host differ from job to job.
"""

import argparse
import importlib
import json
import os
import sys


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
           "resblock": cs.phase_resblock(gen), "vq_profile": {}}
    for N in (512, 2048, 1600, 6400):
        x, e = cs._vq_case(gen, N)
        mask = torch.ones(N, device="cuda")

        def calls():
            for _ in range(20):
                vq.vq_nearest(x, e)
                vq.vq_nearest_stats(x, e, mask)

        calls()
        res["vq_profile"][N] = cs.profile_call(calls, f"[N={N}]", "20 snaps + 20 stats")
    cs.log(env["nvidia_smi"])
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
