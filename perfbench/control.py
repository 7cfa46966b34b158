"""The readings a cell's limits are set from: the program's and its control's.

    python perfbench/control.py --workload <cell> --seconds <s> --seeds <n> ... [--control]

For each seed, one run of the cell as the benchmark runs it (set-up, the
window, what it produced judged by the plain reference) gives the program's
readings; with ``--control`` the same work is judged again with the
reference computed in TF32 in the program's place: for a served cell the
same served requests (``reference/judge_tts.py``), for a training cell the
checked steps (each of the program's two runs of them also read apart), and
beside them the fault "half of the batch left out" planted in the reference
(``reference/judge_train.py``). One JSON line a
seed, then the largest program reading and the smallest control reading of
each number. The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from perfbench import core
    from perfbench.reference import judge_train, judge_tts

    b = core.bench()
    entry = next(w for w in b["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    wl, mix, cfg = core.workload(args.workload), core.mix(entry["traffic"]), core.config(entry["config"])
    program, control, half = {}, {}, {}
    for seed in args.seeds:
        cell = core.Cell(name=args.workload, workload=dict(wl, chips=entry["chips"]), mix=mix, config=cfg, seed=seed,
                         seconds=args.seconds, trace=False, device=torch.device("cuda", 0),
                         t_start=time.perf_counter())
        out = core.driver(mix["driver"]).run(cell)
        line = {"seed": seed, "program": {k: v for k, (v, _) in out["checks"].items()},
                "attempted": out["attempted"], "e2e": out["e2e"]}
        if args.control:
            j = out["judged"]
            if mix["driver"] == "train_step":
                ref = judge_train.follow(j["spec"], cfg, cell.device, j["checked"])
                line["sides"] = [judge_train.compare(side, ref) for side in j["program"]]  # set-up's, after the window
                line["worst_leaves"] = [judge_train.worst(side, ref) for side in j["program"]]
                line["control"] = judge_train.compare(
                    judge_train.follow(j["spec"], cfg, cell.device, j["checked"], precision="tf32"), ref)
                line["half_batch"] = judge_train.compare(
                    judge_train.follow(j["spec"], cfg, cell.device, j["checked"], rows=mix["batch_size"] // 2), ref)
            else:
                line["control"] = judge_tts.judge(j["W"], cfg["program"]["task"], mix["engine"], j["texts"],
                                                  j["served"], j["durs"], control=True)
        print(json.dumps(line), flush=True)
        for k, v in line["program"].items():
            program[k] = max(program.get(k, v), v)
        for k, v in line.get("control", {}).items():
            control[k] = min(control.get(k, v), v)
        for k, v in line.get("half_batch", {}).items():
            half[k] = min(half.get(k, v), v)
        del out
        torch.cuda.empty_cache()
    print(json.dumps({"program_max": program, "control_min": control, "half_batch_min": half}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
