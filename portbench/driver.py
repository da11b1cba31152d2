"""One general driver of the traffic mixes.

A mix (``traffic/<name>.json``) lists the calls of its set-up and of its
*unit*, the call sequence a user makes, in terms of the model's public
methods:

* ``{"op": "warm_start", "steps": S, "lr": 0.01}``
* ``{"op": "sample_hypers", "warmup": W, "samples": S, "chains": C,
  "algorithm": "nuts" | "hmc", "leapfrog": L}``
* ``{"op": "optimize_Z", "steps": S, "lr": 0.01}``
* ``{"op": "predict"}`` (the mixture predictive on the training rows)

and ``"fresh_model"``: whether each unit starts from a new model (a whole
fit); if not, ``"carry_state"``: whether a unit continues from the state the
previous one left or starts again from the set-up's.
Every call runs inside a span of its own (``torch.profiler.record_function``
named ``pb.<op>``, timed on the host clock, ending in ``synchronize``) and
leaves a record of what it was given and what it returned, which the check
and the per-layer metrics read. Each ``sample_hypers`` call gets its own
``torch.Generator`` seeded from (run seed, unit, call); with
``"unit_seeds": K`` the units instead draw from a fixed pool of K seeds, in
an order the run seed rotates, and the window runs whole passes over the
pool, so that every run does the same work whatever the card's speed (NUTS's
work depends on its random stream).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

__all__ = ["HERE", "load", "Span", "Recorder", "op_seed", "Run"]

HERE = os.path.dirname(os.path.abspath(__file__))


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Span:
    name: str
    unit: int                 # -1 for set-up
    t0: float
    t1: float = 0.0
    info: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Recorder:
    """The spans of one run, in memory."""

    def __init__(self, sync):
        self.spans: list[Span] = []
        self._sync = sync

    def run(self, name, unit, fn, **info):
        """Call ``fn(info)`` inside span ``pb.<name>``; returns its result."""
        from torch.profiler import record_function
        span = Span(name, unit, 0.0, info=info)
        with record_function(f"pb.{name}"):
            span.t0 = time.perf_counter()
            out = fn(span.info)
            self._sync()
            span.t1 = time.perf_counter()
        self.spans.append(span)
        return out

    def of(self, name):
        """The window's spans of call ``name``."""
        return [s for s in self.spans if s.name == name and s.unit >= 0]


def op_seed(seed: int, unit: int, call: int, pool: int = 0) -> int:
    """A generator seed for call ``call`` of unit ``unit`` (-1: set-up); with
    a pool of ``pool`` seeds, unit u draws pool entry (u + seed) mod pool."""
    if pool and unit >= 0:
        seed, unit = 0, (unit + seed) % pool
    ss = np.random.SeedSequence([seed % 2 ** 64, unit + 1, call])
    hi, lo = ss.generate_state(2, np.uint32)
    return int(hi) << 31 | int(lo) >> 1


class Run:
    """The model, its data on the device and the recorder of one run."""

    def __init__(self, cfg: dict, mix: dict, seed: int, X, y, Z, *, device):
        from ggp_tpu_torch.models import BayesianSparseGPR_HMC
        self.cls = BayesianSparseGPR_HMC
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        dt = getattr(torch, cfg["dtype"])
        self.X = torch.as_tensor(X, dtype=dt, device=self.device).contiguous()
        self.y = torch.as_tensor(y, dtype=dt, device=self.device).contiguous()
        self.Z0 = torch.as_tensor(Z, dtype=dt, device=self.device).contiguous()
        self.sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        self.rec = Recorder(self.sync)
        self.model = None

    def fresh(self):
        m = self.cls(self.X, self.y, Z_init=self.Z0, jitter=self.cfg["jitter"],
                     device=self.device)
        m.theta = torch.full_like(m.theta, self.cfg["theta_init"])
        return m

    def call(self, model, op: dict, unit: int, k: int):
        """Run op ``op`` (call ``k`` of unit ``unit``) on ``model``."""
        kind = op["op"]
        if kind == "warm_start":
            def fn(info):
                info.update(theta0=model.theta.clone(), Z0=model.Z)
                info["losses"] = model.warm_start(num_steps=op["steps"], lr=op["lr"])
                info.update(theta=model.theta, Z=model.Z)
            return self.rec.run(kind, unit, fn, steps=op["steps"], lr=op["lr"])
        if kind == "sample_hypers":
            seed = op_seed(self.seed, unit, k, self.mix.get("unit_seeds", 0))

            def fn(info):
                gen = torch.Generator(device=self.device).manual_seed(seed)
                info["Z"] = model.Z
                model.sample_hypers(op["warmup"], op["samples"], gen,
                                    num_chains=op["chains"], algorithm=op["algorithm"],
                                    num_leapfrog=op.get("leapfrog", 10))
                info.update(trace=model.trace, stats=model.stats)
            return self.rec.run(kind, unit, fn, seed=seed, warmup=op["warmup"],
                                samples=op["samples"], chains=op["chains"],
                                algorithm=op["algorithm"], leapfrog=op.get("leapfrog", 10))
        if kind == "optimize_Z":
            def fn(info):
                info.update(Z0=model.Z, thetas=model.trace)
                info["losses"] = model.optimize_Z(num_steps=op["steps"], lr=op["lr"])
                info["Z"] = model.Z
            return self.rec.run(kind, unit, fn, steps=op["steps"], lr=op["lr"],
                                rows=int(model.trace.shape[0]))
        if kind == "predict":
            def fn(info):
                info.update(trace=model.trace, Z=model.Z)
                info["mean"], info["var"] = model.mixture_posterior_predictive(self.X)
            return self.rec.run(kind, unit, fn)
        raise ValueError(f"unknown op {kind!r}")

    def setup(self):
        """The mix's set-up on the model the window starts from."""
        if not self.mix["fresh_model"]:
            self.model = self.fresh()
            for k, op in enumerate(self.mix["setup"]):
                self.call(self.model, op, -1, k)
            self.start = (self.model.theta, self.model.Z)

    def warm_up(self):
        """Each kernel and library call of the unit once, at the smallest
        call that launches it, on a copy of the state that is thrown away."""
        small = {"warm_start": dict(steps=1), "optimize_Z": dict(steps=1),
                 "sample_hypers": dict(warmup=1, samples=1), "predict": {}}
        model = self.fresh()
        if self.model is not None:
            model.theta, model.Z = self.model.theta.clone(), self.model.Z.clone()
        spans = list(self.rec.spans)
        for k, op in enumerate(self.mix["unit"]):
            self.call(model, {**op, **small[op["op"]]}, -1, 1000 + k)
        self.rec.spans = spans
        self.sync()

    def unit(self, u: int):
        model = self.fresh() if self.mix["fresh_model"] else self.model
        if not self.mix["fresh_model"] and not self.mix["carry_state"]:
            model.theta, model.Z = self.start
        for k, op in enumerate(self.mix["unit"]):
            self.call(model, op, u, k)

    def window(self, seconds: float):
        """Units back to back (for a pool mix, whole passes over the pool);
        none starts after ``seconds``. Returns (units, window seconds)."""
        self.sync()
        t0 = time.perf_counter()
        u = 0
        while u == 0 or time.perf_counter() - t0 < seconds:
            for _ in range(self.mix.get("unit_seeds", 1)):
                self.unit(u)
                u += 1
        self.sync()
        return u, time.perf_counter() - t0

    def draws(self) -> int:
        """Kept posterior draws of all chains in the window."""
        return sum(s.info["chains"] * s.info["samples"] for s in self.rec.of("sample_hypers"))
