"""Run one cell of the benchmark of ``msmctts_tpu_torch`` once.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program. The run builds the cell's
configuration over weights drawn on the card, warms the cell's shapes,
measures for ``--seconds`` and checks what the timed path served against
the plain reference. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared, with
its limit, as the last lines of standard error also give them.

It exits non-zero and prints no result without a card (or with fewer than
the cell asks for), when the cell fails to run, or when a module of JAX or
of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the checkout's root, never this folder: its subfolders must not shadow modules
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import core

    b = core.bench()
    entry = next((w for w in b["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    wl = core.workload(args.workload)
    cell = core.Cell(name=args.workload, workload=dict(wl, chips=entry["chips"]), mix=core.mix(entry["traffic"]),
                     config=core.config(entry["config"]),
                     seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     device=torch.device("cuda", 0), t_start=T_START)
    result = core.run_cell(cell, b)
    found = core.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    if args.trace:  # the peaks the rooflines count against assume the card's full power limit
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        print(f"card: {smi.stdout.strip() or smi.stderr.strip()}; peaks: 495 TFLOP/s TF32, 3.35 TB/s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
