"""The comparison that decides ``correct``.

After the window, the plain reference (``reference/``, float64) works out
again what a sample of the window's calls produced, from the inputs the
benchmark made and the calls' own starting points:

* ``potential_gap``: the potential the sampler reports at each kept draw of
  the window against the reference's, per data row;
* ``draw_gap``: the distance (max-abs, log-hyper units) from each sampled
  transition's next draw to the nearest point of the reference's replayed
  trajectory (the leapfrog integrator and so the core's gradient);
* ``stuck_transitions``: the sampled transitions that stayed at their start
  where the replay leaves it by a clear margin (exact: none may);
* ``accept_gap`` (HMC): the accept probability against the reference's;
* ``warm_loss_gap``: the warm starts' losses over their first
  ``WARM_STEPS_HELD`` steps against the reference trainer's from the same
  start, per data row (past them float32 and its control part by rounding);
* ``z_loss_gap``: the Z steps' losses at every step against the reference
  trainer's from the same start, per data row; ``z_final_gap``: the Z they
  end at against the reference trainer's (max-abs, input units);
* ``predict_gap``: the mixture predictive's means and variances against the
  reference's, in predictive standard deviations and relative variance.

The sampled transitions and the unit whose trainers and predictive are held
are drawn from the run's seed; every kept draw is held to its potential.
``control_run`` puts the control in the program's place: the same record with
every output that the numbers read worked out by the reference in float32
with its matrix products in TF32 or bfloat16 (the cell's ``"control"``), so
that ``numbers`` and ``judge`` read it as they read the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .reference import adam, bound, sampler
from .reference.slabs import sampling_slabs

__all__ = ["numbers", "judge", "control_run", "SAMPLED_TRANSITIONS", "MAX_DEPTH", "MOVE_MARGIN",
           "WARM_STEPS_HELD"]

SAMPLED_TRANSITIONS = 16
MAX_DEPTH = 8                  # the model's NUTS depth (NUTSConfig.max_depth)
# a replayed transition has surely left its start when its acceptance beats
# the uniform by this much in log probability: ~10x the float32 energy error
MOVE_MARGIN = 0.1
WARM_STEPS_HELD = 100


def _rows(t, C, S):
    return torch.as_tensor(t).reshape(C, S)


def _pick(seed, salt, n, k):
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64, salt]))
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


class _Ctx:
    """The reference's inputs in one precision: float64, or with ``control``
    ("tf32" or "bf16") float32 with its matrix products in that precision."""

    def __init__(self, run, control=None):
        self.dt = torch.float32 if control else torch.float64
        self.control = control
        self.X = run.X.to(self.dt)
        self.y = run.y.to(self.dt)
        self.jitter = run.cfg["jitter"]
        self.n = run.X.shape[0]

    def f(self, t):
        return torch.as_tensor(t).to(device=self.X.device, dtype=self.dt)


def _potentials(z, X, y, Z, jitter, ctx):
    """U at each hyper row of z, in blocks that fit, in ``ctx``'s precision."""
    n = X.shape[0]
    block = max(1, int(2e8 // (n * Z.shape[0] * 8)))
    out = []
    for i in range(0, z.shape[0], block):
        with bound.precision(ctx.control):
            out.append(bound.neg_logpost(ctx.f(z[i:i + block]), X, y, ctx.f(Z), jitter))
    return torch.cat(out)


def _potential_gap(run, ref: _Ctx):
    """The widest gap, over every kept draw of the window, between the
    potential the sampler reports and the reference's, per data row."""
    worst = 0.0
    for s in run.rec.of("sample_hypers"):
        got = torch.as_tensor(s.info["stats"]["potential"]).reshape(-1)
        want = _potentials(s.info["trace"], ref.X, ref.y, s.info["Z"], ref.jitter, ref)
        gap = (got.double().cpu() - want.double().cpu()).abs().nan_to_num(math.inf).max()
        worst = max(worst, float(gap) / ref.n)
    return worst


def _transitions(run, seed):
    """The sampled transitions: (span, chain, t) with t >= 1."""
    spans = run.rec.of("sample_hypers")
    cands = [(s, c, t) for s in spans for c in range(s.info["chains"])
             for t in range(1, s.info["samples"])]
    return [cands[i] for i in _pick(seed, 1, len(cands), SAMPLED_TRANSITIONS)]


def _transition_rows(run, seed):
    """The sampled transitions with what their replay needs: the start, the
    step size and inverse mass, the random slabs drawn again from the call's
    generator seed, and what the program made of them."""
    slabs = {}
    rows = []
    for s, c, t in _transitions(run, seed):
        inf = s.info
        C, S = inf["chains"], inf["samples"]
        dim = inf["trace"].shape[-1]
        if id(s) not in slabs:
            slabs[id(s)] = sampling_slabs(inf["seed"], chains=C, dim=dim,
                                          warmup=inf["warmup"], samples=S,
                                          algorithm=inf["algorithm"], max_depth=MAX_DEPTH,
                                          dtype=inf["trace"].dtype,
                                          device=inf["trace"].device)
        sl = slabs[id(s)]
        tr = inf["trace"].reshape(C, S, dim)
        st = inf["stats"]
        rows.append(dict(
            span=s, chain=c, t=t,
            algorithm=inf["algorithm"], L=inf["leapfrog"], Z=inf["Z"],
            z0=tr[c, t - 1], z1=tr[c, t],
            eps=torch.as_tensor(st["step_size"]).reshape(C)[c],
            inv_mass=torch.as_tensor(st["inv_mass"]).reshape(C, dim)[c],
            a=_rows(st["accept_prob"], C, S)[c, t],
            depth=int(_rows(st["depth"], C, S)[c, t]),
            **{k: v[t, c] for k, v in sl.items()}))
    return rows


def _trajectories(rows, algo, ctx: _Ctx):
    """Each row's replayed trajectory in ``ctx``'s precision: (points (k, dim)
    float64 on the host, whether the replay surely moves, HMC's accept
    probability or None)."""
    def stack(key):
        return torch.stack([ctx.f(r[key]) for r in rows])

    Zb = stack("Z")

    def vg(z, idx=None):
        with bound.precision(ctx.control):
            return bound.neg_logpost_vg(z, ctx.X, ctx.y, Zb if idx is None else Zb[idx],
                                        ctx.jitter)

    z0, eps, im, mom = (stack(k) for k in ("z0", "eps", "inv_mass", "mom"))
    with bound.precision(ctx.control):
        if algo == "hmc":
            pts, acc = sampler.hmc_trajectories(z0, eps, im, mom, rows[0]["L"], vg)
            pts = [p.double().cpu() for p in pts]
            sure = (torch.log(stack("mh")) < torch.log(acc) - MOVE_MARGIN).tolist()
            return pts, sure, acc.double().cpu()
        treeu = stack("treeu")
        U0, r0, leaves = sampler.nuts_trajectories(
            z0, eps, im, mom, treeu, [r["depth"] for r in rows], vg)
        pts = [torch.cat([z0[j].double().cpu()[None]] + [lv[0] for lv in leaves[j]])
               for j in range(len(rows))]
        sure = sampler.first_leaf_accepted(r0, U0, leaves, treeu, im, MOVE_MARGIN)
        return pts, sure, None


def _distances(rows, pts):
    """Each row's next draw's max-abs distance to each point of its replay."""
    return [(p - r["z1"].double().cpu()).abs().amax(-1).nan_to_num(math.inf)
            for r, p in zip(rows, pts)]


def _sampler_numbers(run, seed, ref: _Ctx):
    rows = _transition_rows(run, seed)
    out = {}
    for algo in ("hmc", "nuts"):
        sel = [r for r in rows if r["algorithm"] == algo]
        if not sel:
            continue
        pts, moves, acc = _trajectories(sel, algo, ref)
        dist = _distances(sel, pts)
        stayed = [bool((r["z1"] == r["z0"]).all()) for r in sel]
        found = {"draw_gap": float(max(float(d.min()) for d in dist)),
                 "stuck_transitions": float(sum(m and s for m, s in zip(moves, stayed)))}
        if acc is not None:
            a = torch.stack([r["a"].double().cpu() for r in sel])
            found["accept_gap"] = float((a - acc).abs().max())
        for k, v in found.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def _loss_gap(got, want, n):
    got = torch.as_tensor(got).double().cpu()
    want = want.double().cpu()
    if got.shape != want.shape:
        return math.inf
    return float((got - want).abs().nan_to_num(math.inf).max()) / n


def _held_spans(run, seed):
    """The trainer and predictive spans the check holds: the set-up's, and
    those of one unit drawn from the seed."""
    window = run.rec.of("warm_start") + run.rec.of("optimize_Z") + run.rec.of("predict")
    units = sorted({s.unit for s in window})
    chosen = units[_pick(seed, 2, len(units), 1)[0]] if units else None
    return [s for s in run.rec.spans if s.unit < 0 or s.unit == chosen]


def _warm_args(run, inf, ctx: _Ctx):
    th0 = torch.full((run.X.shape[1] + 2,), float(run.cfg["theta_init"]))
    kw = dict(steps=min(inf["steps"], WARM_STEPS_HELD), lr=inf["lr"],
              clip=run.cfg["warm_clip"], min_noise=run.cfg["min_noise"])
    return (ctx.f(th0), ctx.f(inf["Z0"]), ctx.X, ctx.y, ctx.jitter), kw


def _trainer_numbers(run, seed, ref: _Ctx):
    out = {}
    for s in _held_spans(run, seed):
        inf = s.info
        if s.name == "warm_start":
            args, kw = _warm_args(run, inf, ref)
            want = adam.warm_start(*args, **kw)[2]
            out["warm_loss_gap"] = max(out.get("warm_loss_gap", 0.0),
                                       _loss_gap(inf["losses"][:kw["steps"]], want, ref.n))
        elif s.name == "optimize_Z":
            want_Z, want = adam.z_steps(ref.f(inf["Z0"]), ref.f(inf["thetas"]), ref.X, ref.y,
                                        ref.jitter, steps=inf["steps"], lr=inf["lr"])
            gap = float((inf["Z"].double().cpu() - want_Z.double().cpu()).abs()
                        .nan_to_num(math.inf).max())
            out["z_final_gap"] = max(out.get("z_final_gap", 0.0), gap)
            out["z_loss_gap"] = max(out.get("z_loss_gap", 0.0),
                                    _loss_gap(inf["losses"], want, ref.n))
        elif s.name == "predict":
            mu, var = bound.predict(ref.f(inf["trace"]), ref.X, ref.y, ref.f(inf["Z"]),
                                    ref.jitter, ref.X)
            gm, gv = inf["mean"], inf["var"]
            if gm.shape != mu.shape:
                gap = math.inf
            else:
                gm, gv, mu, var = (t.double().cpu() for t in (gm, gv, mu, var))
                gap = float(torch.maximum((gm - mu).abs() / var.sqrt(),
                                          (gv - var).abs() / var).nan_to_num(math.inf).max())
            out["predict_gap"] = max(out.get("predict_gap", 0.0), gap)
    return out


def numbers(run, seed: int, wanted=None) -> dict:
    """The compared numbers of a finished run, or of the control put in its
    place (``control_run``). ``wanted`` (names) spares the pass over every
    draw's potential where the cell does not compare it."""
    ref = _Ctx(run)
    with torch.no_grad():
        out = _sampler_numbers(run, seed, ref)
        if run.rec.of("sample_hypers") and (wanted is None or "potential_gap" in wanted):
            out["potential_gap"] = _potential_gap(run, ref)
        out.update(_trainer_numbers(run, seed, ref))
    return out


class _Stand:
    """A finished run's data and a record of spans, as ``numbers`` reads it."""

    def __init__(self, run, spans):
        self.X, self.y, self.cfg = run.X, run.y, run.cfg
        self.rec = type(run.rec).__new__(type(run.rec))
        self.rec.spans = spans


def control_run(run, seed: int, mode: str):
    """The control in the program's place: ``run``'s record with what the
    numbers read of the program's outputs worked out instead by the reference
    in float32 with its matrix products in ``mode`` ("tf32" or "bf16"): each
    sampled transition's next draw (the control's trajectory point at the
    index of the program's draw, so that a choice rounding may flip is taken
    as the program took it) and HMC's accept probability, every kept draw's
    potential, and the held trainers' losses and Z and the predictive."""
    ref, ctl = _Ctx(run), _Ctx(run, mode)
    spans = [dataclasses.replace(s, info=dict(s.info)) for s in run.rec.spans]
    twin = {id(a): b for a, b in zip(run.rec.spans, spans)}
    own = dict(memory_format=torch.contiguous_format)   # so that a reshape is a view
    for s in spans:
        if s.name == "sample_hypers":
            s.info["trace"] = s.info["trace"].clone(**own)
            s.info["stats"] = {**s.info["stats"],
                               "accept_prob": torch.as_tensor(s.info["stats"]["accept_prob"])
                               .clone(**own)}
    stand = _Stand(run, spans)
    with torch.no_grad():
        # in waves, so that a transition that follows a sampled one starts
        # from where the control took that one, as the numbers replay it
        pending = _transition_rows(stand, seed)
        while pending:
            keys = {(id(r["span"]), r["chain"], r["t"]) for r in pending}
            wave = [r for r in pending if (id(r["span"]), r["chain"], r["t"] - 1) not in keys]
            done = {id(r) for r in wave}
            pending = [r for r in pending if id(r) not in done]
            for algo in ("hmc", "nuts"):
                sel = [r for r in wave if r["algorithm"] == algo]
                if not sel:
                    continue
                pts = _trajectories(sel, algo, ref)[0]
                cpts, _, cacc = _trajectories(sel, algo, ctl)
                for j, (r, d) in enumerate(zip(sel, _distances(sel, pts))):
                    inf = r["span"].info
                    C, S = inf["chains"], inf["samples"]
                    tr = inf["trace"].reshape(C, S, -1)
                    tr[r["chain"], r["t"]] = cpts[j][int(d.argmin())].to(tr)
                    if cacc is not None:
                        a = _rows(inf["stats"]["accept_prob"], C, S)
                        a[r["chain"], r["t"]] = cacc[j].to(a)
        for s in spans:
            inf = s.info
            if s.name == "sample_hypers" and s.unit >= 0:
                inf["stats"]["potential"] = _potentials(inf["trace"], ctl.X, ctl.y, inf["Z"],
                                                        ctl.jitter, ctl)
        for s in _held_spans(run, seed):
            inf = twin[id(s)].info
            with bound.precision(mode):
                if s.name == "warm_start":
                    args, kw = _warm_args(run, inf, ctl)
                    inf["losses"] = adam.warm_start(*args, **kw)[2]
                elif s.name == "optimize_Z":
                    inf["Z"], inf["losses"] = adam.z_steps(
                        ctl.f(inf["Z0"]), ctl.f(inf["thetas"]), ctl.X, ctl.y, ctl.jitter,
                        steps=inf["steps"], lr=inf["lr"])
                elif s.name == "predict":
                    inf["mean"], inf["var"] = bound.predict(
                        ctl.f(inf["trace"]), ctl.X, ctl.y, ctl.f(inf["Z"]), ctl.jitter, ctl.X)
    return stand


def judge(found: dict, limits: dict):
    """(correct, the compared numbers each with its limit). A number the
    cell lists that the run did not give fails."""
    rows = {k: {"value": found.get(k, math.inf), "limit": lim} for k, lim in limits.items()}
    ok = all(r["value"] <= r["limit"] for r in rows.values())
    return ok, rows
