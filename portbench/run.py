"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload boston-hmc-c8 --seed 7 --seconds 40 --trace 0

A cell (``workloads/<name>.json``) names a configuration (``configs/``), a
traffic mix (``traffic/``) and the limits of its compared numbers. A run:

1. set-up: imports the program, makes the data on the host from the
   configuration, builds or loads the program's kernels, puts the model on
   the card, runs the mix's set-up and one smallest call of each of the unit's
   calls (counted in ``setup_s``, from the moment ``import torch`` has
   returned: torch's own import is the machine's, read from its disk, and is
   printed on its own);
2. the window: the mix's unit back to back, none started after ``--seconds``;
   ``draws_per_s`` is the kept posterior draws of all units over the window's
   seconds. With ``--trace 1`` the window runs under ``torch.profiler`` and the
   per-layer metrics (``metrics/<name>.py``) are reported instead;
3. the check (``check.py``) against the plain reference, after the window and
   outside every metric; then the result line.

It refuses to run without a CUDA device, and gives no result if the JAX
package or JAX itself was loaded.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import math
import os
import sys
import time

__all__ = ["execute", "main", "FORBIDDEN"]

# top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "ggp_tpu")


def _readers():
    from .driver import HERE
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "metrics", "*.py"))):
        name = os.path.basename(path)[:-3]
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = (mod.read, mod.UNIT)
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _health(run):
    lines = []
    for s in run.rec.of("sample_hypers"):
        st = s.info["stats"]
        lines.append(f"unit {s.unit} sample_hypers: divergent share "
                     f"{float(st['diverging'].float().mean()):.4f}, mean accept "
                     f"{float(st['accept_prob'].mean()):.4f}, step size "
                     f"{[round(float(e), 5) for e in st['step_size'].reshape(-1)]}")
    return lines


def _failed_units(run):
    bad = set()
    for s in run.rec.spans:
        if s.unit < 0:
            continue
        for key in ("trace", "losses", "mean"):
            t = s.info.get(key)
            if t is not None and not bool(t.isfinite().all()):
                bad.add(s.unit)
    return len(bad)


def execute(workload: dict, cfg: dict, mix: dict, *, seed: int, seconds: float, trace: bool,
            device: str, t_start: float):
    """One run on ``device``. Returns (result dict, lines for stderr)."""
    import torch

    from . import check
    from .data import make_inputs
    from .driver import Run
    from .trace import Traced

    cuda = device == "cuda"
    marks = [("imports", time.perf_counter())]
    X, y, Z = make_inputs(cfg)
    marks.append(("data", time.perf_counter()))
    if cuda:
        torch.cuda.init()
        marks.append(("CUDA init", time.perf_counter()))
        from ggp_tpu_torch.ops import _build
        _build.build()
        marks.append(("kernels built or loaded", time.perf_counter()))
    from ggp_tpu_torch.ops._build import LAUNCHES
    run = Run(cfg, mix, seed, X, y, Z, device=device)
    run.setup()
    marks.append(("the mix's set-up", time.perf_counter()))
    run.warm_up()
    marks.append(("warm-up calls", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    before = dict(LAUNCHES)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function("pb.window"):
                units, window_s = run.window(seconds)
    else:
        units, window_s = run.window(seconds)
    launches = {k: v - before.get(k, 0) for k, v in LAUNCHES.items() if v != before.get(k, 0)}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded {', '.join(found)}: the benchmark runs the port alone")
    t = Traced(run, window_s, launches, prof)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    per_unit = [round(sum(s.seconds for s in run.rec.spans if s.unit == u), 3) for u in range(units)]
    phases = ", ".join(f"{name} {b - a:.3f}" for (name, b), (_, a)
                       in zip(marks, [("start", t_start)] + marks[:-1]))
    lines = [f"window: {units} units, {t.draws} draws, {window_s:.3f} s; set-up {setup_s:.3f} s "
             f"({phases}); units' seconds {per_unit}; launches {json.dumps(launches)}"] + _health(run)
    if trace:
        metrics = {}
        for name, (read, unit) in _readers().items():
            v = read(t)
            if v is not None:
                metrics[name] = {"value": v, "unit": unit}
        dev.update(busy_s=t.busy_s, window_s=t.traced_window_s)
    else:
        metrics = {"draws_per_s": {"value": t.draws / window_s, "unit": "draws/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    result = {"correct": False, "attempted": units, "failed": _failed_units(run),
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = t.breakdown()
    run.model = None
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ok, rows = check.judge(check.numbers(run, seed, wanted=workload["limits"]), workload["limits"])
    lines.append(f"check took {time.perf_counter() - t_check:.3f} s")
    lines += [f"{k}: {r['value']!r} (limit {r['limit']!r})" for k, r in rows.items()]
    result["correct"] = bool(ok and result["failed"] == 0)
    result["checks"] = rows
    return result, lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_torch = time.perf_counter()
    import torch
    t_start = time.perf_counter()

    from .driver import load
    workload = load("workloads", args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = execute(workload, load("configs", workload["config"]),
                            load("traffic", workload["traffic"]), seed=args.seed,
                            seconds=args.seconds, trace=bool(args.trace), device="cuda",
                            t_start=t_start)
    lines[0] += f"; import torch {t_start - t_torch:.3f} s, not in setup_s"
    for line in lines:
        print(line, file=sys.stderr)
    result["checks"] = {k: {"value": r["value"] if math.isfinite(r["value"]) else str(r["value"]),
                            "limit": r["limit"]} for k, r in result["checks"].items()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
