"""The readings that the limits of a cell's compared numbers are set from.

    python3 -m portbench.control --workload elevator-nuts-z --seeds 1-12 --control 3

For each seed, in one process: the cell's set-up and one unit, then the
compared numbers of the program (the lower readings) and, for the first
``--control`` seeds, of the control: the plain reference in float32 with its
matrix products in the cell's control precision (``"control"``: TF32 or
bfloat16) put in the program's place (``check.control_run``; the upper
readings). Each side is judged against the cell's limits as a run judges the
program. One JSON line per seed. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import check
from .data import make_inputs
from .driver import Run, load

__all__ = ["readings", "main"]


def readings(workload: dict, cfg: dict, mix: dict, seed: int, control, device="cuda"):
    """One seed's readings; ``control``: the control's precision, or None."""
    X, y, Z = make_inputs(cfg)
    run = Run(cfg, mix, seed, X, y, Z, device=device)
    run.setup()
    t0 = time.perf_counter()
    run.unit(0)
    run.sync()
    out = {"seed": seed, "unit_s": time.perf_counter() - t0, "draws": run.draws(),
           "program": check.numbers(run, seed)}
    out["program_correct"] = check.judge(out["program"], workload["limits"])[0]
    if control:
        out["control"] = check.numbers(check.control_run(run, seed, control), seed)
        out["control_correct"] = check.judge(out["control"], workload["limits"])[0]
    return out


def _seeds(text):
    a, _, b = text.partition("-")
    return list(range(int(a), int(b or a) + 1))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1-12")
    p.add_argument("--control", type=int, default=3)
    args = p.parse_args(argv)
    w = load("workloads", args.workload)
    cfg, mix = load("configs", w["config"]), load("traffic", w["traffic"])
    for i, seed in enumerate(_seeds(args.seeds)):
        r = readings(w, cfg, mix, seed, w["control"] if i < args.control else None)
        print(json.dumps({"workload": args.workload, **r}), flush=True)
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
