"""The xlstm-125m launcher's eval loss at several learning rates and local
step counts, on the card: where its loss falls and where it rises.

Runs ``python -m repro_torch.launch.train --arch xlstm-125m --full-config
--mesh 1,1,1 --seq 1024 --batch 2 --epochs 1`` in process (its ``main``)
once a setting of (lr, LAR, rounds) and prints a JSON line a setting: the
eval losses (the drawn model's, then each round's), each round's surviving
mass and wall ms, and the seconds the run took; then the card's name and
power limit.  Run from the repository root on a machine with a card:

    PYTHONPATH=src python tools/xlstm_launcher_lr.py [--settings 0.1,2,4 0.03,2,4 ...]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.launch import train

SETTINGS = ("0.1,2,4", "0.05,2,4", "0.03,2,4", "0.02,2,4", "0.01,2,4",
            "0.03,4,3", "0.01,4,3")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--settings", nargs="+", default=SETTINGS,
                    metavar="LR,LAR,ROUNDS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("xlstm_launcher_lr: no CUDA device")
    for setting in args.settings:
        lr, lar, rounds = setting.split(",")
        t0 = time.perf_counter()
        res = train.main(["--arch", "xlstm-125m", "--full-config", "--mesh",
                          "1,1,1", "--seq", "1024", "--batch", "2",
                          "--epochs", "1", "--lr", lr, "--lar", lar,
                          "--rounds", rounds])
        print("setting " + json.dumps({
            "lr": float(lr), "lar": int(lar), "rounds": int(rounds),
            "eval_loss": [res["init_loss"], *res["loss"]],
            "mass": res["mass"], "round_ms": res["round_ms"],
            "seconds": time.perf_counter() - t0}), flush=True)
        del res
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
