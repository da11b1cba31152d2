"""The check catches a broken timed path. Each cell runs here on the CPU at a
small size, past the harness's look for a card, with the program's plain
versions underneath and the cell's own limits: sound, ``correct`` is true;
with each fault the cell can have planted in the program, it is false.

The faults: a sampler or trainer step that returns its state unchanged; half
of the batch left out with the mean taken over the rest (the Z steps' trace
rows, the warm start's data rows); an answer
altered where it is produced (every other kept draw; one predictive mean). A cell on
one chip has no exchange between chips to leave out.
"""

import json
import time

import pytest
import torch

import ggp_tpu_torch.models.bayesian_sgpr_hmc as model_mod
from portbench import check
from portbench.data import make_inputs
from portbench.driver import Run, load
from portbench.run import execute

CELLS = ("boston-hmc-c8", "elevator-nuts-z", "boston-headline", "elevator-hmc-c8")
SMALL = {"warm_start": dict(steps=30), "optimize_Z": dict(steps=100),
         "sample_hypers": dict(warmup=40, samples=6)}


def _cell(name):
    w = load("workloads", name)
    cfg = {**load("configs", w["config"]), "N": 90, "D": 3, "M": 8}
    mix = json.loads(json.dumps(load("traffic", w["traffic"])))
    for part in ("setup", "unit"):
        mix[part] = [{**op, **SMALL.get(op["op"], {})} for op in mix[part]]
    return w, cfg, mix


def _run(name, seed=11):
    w, cfg, mix = _cell(name)
    torch.set_num_threads(2)
    res, _ = execute(w, cfg, mix, seed=seed, seconds=0.0, trace=False, device="cpu",
                     t_start=time.perf_counter())
    return res


def _sampler_stays(fn):
    def wrapped(*a, **kw):
        zs, stats = fn(*a, **kw)
        z0 = a[5] if fn is _REAL["single_chain_fused"] else a[1]
        return (z0 if zs.ndim == 2 else z0[:, None, :]).expand_as(zs).clone(), stats
    return wrapped


def _draws_altered(fn):
    def wrapped(*a, **kw):
        zs, stats = fn(*a, **kw)
        zs = zs.contiguous().clone()
        zs[..., ::2, 0] += 0.05          # every other draw of each chain
        return zs, stats
    return wrapped


def _z_stays(fn):
    def wrapped(Z, m, v, thetas, X, y, jitter, *, t0, num_steps, lr):
        *_, losses = fn(Z, m, v, thetas, X, y, jitter, t0=t0, num_steps=1, lr=lr)
        return Z, m, v, losses.expand(num_steps).clone()
    return wrapped


def _z_half_batch(fn):
    def wrapped(Z, m, v, thetas, *a, **kw):
        return fn(Z, m, v, thetas[: max(1, thetas.shape[0] // 2)].contiguous(), *a, **kw)
    return wrapped


def _warm_stays(fn):
    def wrapped(theta, Z, mt, vt, mz, vz, X, y, jitter, **kw):
        *_, losses = fn(theta, Z, mt, vt, mz, vz, X, y, jitter, **{**kw, "num_steps": 1})
        return (theta, Z, mt, vt, mz, vz, losses.expand(kw["num_steps"]).clone())
    return wrapped


def _warm_half_batch(fn):
    def wrapped(theta, Z, mt, vt, mz, vz, X, y, jitter, **kw):
        h = X.shape[0] // 2
        return fn(theta, Z, mt, vt, mz, vz, X[:h].contiguous(), y[:h].contiguous(), jitter, **kw)
    return wrapped


def _predict_altered(fn):
    def wrapped(*a, **kw):
        mean, var = fn(*a, **kw)
        mean = mean.clone()
        mean[0] += 0.05
        return mean, var
    return wrapped


_REAL = {k: getattr(model_mod, k) for k in ("single_chain_fused", "multichain_fused",
                                             "z_adam_chunk", "sgpr_adam_chunk")}
SAMPLERS = ("single_chain_fused", "multichain_fused")
FAULTS = {
    "sampler state unchanged": {k: _sampler_stays for k in SAMPLERS},
    "draws altered": {k: _draws_altered for k in SAMPLERS},
    "Z step state unchanged": {"z_adam_chunk": _z_stays},
    "Z steps over half the trace rows": {"z_adam_chunk": _z_half_batch},
    "warm start state unchanged": {"sgpr_adam_chunk": _warm_stays},
    "warm start over half the data rows": {"sgpr_adam_chunk": _warm_half_batch},
    "predictive mean altered": {"mixture_posterior_predictive": _predict_altered},
}
APPLIES = {
    "boston-hmc-c8": ["sampler state unchanged", "draws altered", "warm start state unchanged",
                      "warm start over half the data rows"],
    "elevator-hmc-c8": ["sampler state unchanged", "draws altered",
                        "warm start state unchanged", "warm start over half the data rows"],
    "elevator-nuts-z": ["sampler state unchanged", "draws altered", "Z step state unchanged",
                        "Z steps over half the trace rows", "warm start state unchanged",
                        "warm start over half the data rows"],
    "boston-headline": ["sampler state unchanged", "draws altered", "Z step state unchanged",
                        "Z steps over half the trace rows", "warm start state unchanged",
                        "warm start over half the data rows", "predictive mean altered"],
}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in APPLIES[c]])
def test_fault_is_caught(name, fault, monkeypatch):
    for target, wrap in FAULTS[fault].items():
        if target == "mixture_posterior_predictive":
            cls = model_mod.BayesianSparseGPR_HMC
            monkeypatch.setattr(cls, target, wrap(cls.mixture_posterior_predictive))
        else:
            monkeypatch.setattr(model_mod, target, wrap(_REAL[target]))
    res = _run(name)
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_control_in_the_programs_place(name):
    """The control goes through the same numbers and judge as the program:
    in float64 (the reference itself in the program's place, its draws and
    accept probabilities stored in the program's float32) every number reads
    as that rounding, so each output the numbers read is replaced; in the
    cell's control precision it comes out not correct."""
    w, cfg, mix = _cell(name)
    torch.set_num_threads(2)
    run = Run(cfg, mix, 11, *make_inputs(cfg), device="cpu")
    run.setup()
    run.unit(0)
    assert check.judge(check.numbers(run, 11), w["limits"])[0]
    for s in run.rec.of("sample_hypers"):      # strided, as the multichain driver returns them,
        s.info["trace"] = s.info["trace"].t().contiguous().t()   # and off where not replaced
        acc = torch.as_tensor(s.info["stats"]["accept_prob"]) + 0.01
        s.info["stats"]["accept_prob"] = acc.t().contiguous().t() if acc.ndim == 2 else acc
    exact = check.numbers(check.control_run(run, 11, None), 11)
    assert set(exact) >= set(w["limits"]) and max(exact.values()) < 1e-6, exact
    ctl = check.numbers(check.control_run(run, 11, w["control"]), 11)
    assert not check.judge(ctl, w["limits"])[0], ctl
