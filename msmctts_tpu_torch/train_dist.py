"""Launcher of a data-parallel training run (counterpart of the root
``train_dist.py``).

One PyTorch process drives one GPU, so on one host this starts one
``msmctts_tpu_torch.train`` process per local rank and waits for them:

    python -m msmctts_tpu_torch.train_dist -c cfg.yaml --nproc 4            # cards 0-3, nccl
    python -m msmctts_tpu_torch.train_dist -c cfg.yaml --devices 0,0 --backend gloo   # two ranks share card 0
    python -m msmctts_tpu_torch.train_dist -c cfg.yaml --nproc 2 --device cpu          # CPU, gloo

Across hosts, run it on every host with the first host's ``--hosts
host:port``, the total ``--num-processes`` and the index of the host's first
rank as ``--process-id``:

    python -m msmctts_tpu_torch.train_dist -c cfg.yaml --nproc 4 --hosts host0:1234 --num-processes 8 --process-id 0
    python -m msmctts_tpu_torch.train_dist -c cfg.yaml --nproc 4 --hosts host0:1234 --num-processes 8 --process-id 4

Arguments it does not know (``--max-steps``, ``--log-every``) go to every
``train`` process. If a rank exits with an error the others are stopped and
the launcher exits with that code; SIGTERM / SIGINT to the launcher is passed
on to every rank, which then checkpoint and exit together.
"""

from __future__ import annotations

import argparse
import signal
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--nproc", type=int, default=None, help="ranks to start on this host (default: one per --devices entry)")
    p.add_argument("--devices", default=None, help="comma-separated CUDA indices, one per local rank (default 0..nproc-1)")
    p.add_argument("--device", default=None, help="'cpu' runs every local rank on the CPU")
    p.add_argument("--backend", default=None, help="nccl | gloo (default: nccl on GPUs, gloo on the CPU)")
    p.add_argument("--hosts", default=None, help="coordinator host:port (first host); default: a free local port")
    p.add_argument("--num-processes", type=int, default=None, help="ranks over all hosts (default: --nproc)")
    p.add_argument("--process-id", type=int, default=0, help="index of this host's first rank")
    args, passthrough = p.parse_known_args(argv)

    if args.device == "cpu":
        nproc = args.nproc or 1
        devices = ["cpu"] * nproc
    else:
        ids = args.devices.split(",") if args.devices else [str(i) for i in range(args.nproc or 1)]
        nproc = args.nproc or len(ids)
        if len(ids) != nproc:
            raise SystemExit(f"--nproc {nproc} does not match --devices {args.devices}")
        devices = [f"cuda:{i}" for i in ids]
    world = args.num_processes or nproc
    coordinator = args.hosts or f"127.0.0.1:{_free_port()}"

    procs = []
    for local, device in enumerate(devices):
        cmd = [sys.executable, "-m", "msmctts_tpu_torch.train", "-c", args.config, "--device", device, *passthrough]
        if world > 1:
            cmd += ["--coordinator", coordinator, "--num-processes", str(world),
                    "--process-id", str(args.process_id + local)]
            if args.backend:
                cmd += ["--backend", args.backend]
        procs.append(subprocess.Popen(cmd))

    def pass_on(signum, frame):
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signum)

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, pass_on)

    code = 0
    try:
        while any(proc.poll() is None for proc in procs):
            failed = [proc.returncode for proc in procs if proc.poll() not in (None, 0)]
            if failed:  # the others would wait for the dead rank inside a collective
                code = failed[0]
                break
            time.sleep(0.2)
        else:
            code = next((proc.returncode for proc in procs if proc.returncode), 0)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        for proc in procs:
            proc.wait()
    return code


if __name__ == "__main__":
    sys.exit(main())
