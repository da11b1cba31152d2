"""Smoke run of the PyTorch/CUDA port (``ggp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one or more lines; any failure is a traceback and a
non-zero exit:

1. device: the card's name and power limit (nvidia-smi); no CUDA -> fail;
2. build: compile the four CUDA kernels from ``ggp_tpu_torch/csrc``;
3. kernel parity: each kernel against its plain PyTorch version on the
   card, at the shapes of the flagship path (bench.py's boston-shaped data:
   N=404 train rows, D=13, M=100), in float64 and float32, with the time
   per call of both;
4. slice: BayesianSparseGPR_HMC as bench.py's headline cell drives it
   (warm start 500 steps, NUTS rounds (100,20),(25,10),(25,10),(100,20)
   with 100 Z steps between rounds, mixture predictive), in float32, with
   every kernel's launch count over that run;
5. a JSON line of per-kernel results, then the final status line.
"""

from __future__ import annotations

import json
import math
import subprocess
import time

import numpy as np
import torch

from ggp_tpu_torch import BayesianSparseGPR_HMC
from ggp_tpu_torch.inference.diagnostics import effective_sample_size
from ggp_tpu_torch.inference.hmc import find_reasonable_step_size
from ggp_tpu_torch.ops import _build
from ggp_tpu_torch.ops.nuts_chunk import (ChainState, draw_slabs, nuts_chunk,
                                          nuts_chunk_plain)
from ggp_tpu_torch.ops.sgpr_adam import (sgpr_adam_chunk, sgpr_adam_chunk_plain,
                                         z_adam_chunk, z_adam_chunk_plain)
from ggp_tpu_torch.ops.vfe_bound import rbf_vfe_neg_logpost_vg, vfe_potential
from ggp_tpu_torch.utils.datasets import normalize
from ggp_tpu_torch.utils.metrics import nlpd_mixture, rmse

KERNELS = {
    "vfe_potential": ("ggp_tpu_torch/csrc/vfe_potential.cu",
                      "ggp_tpu/ops/fused_nuts.py:807"),
    "nuts_chunk": ("ggp_tpu_torch/csrc/nuts_chunk.cu",
                   "ggp_tpu/ops/fused_nuts.py:780"),
    "sgpr_adam_chunk": ("ggp_tpu_torch/csrc/sgpr_adam.cu",
                        "ggp_tpu/ops/fused_sgpr.py:434"),
    "z_adam_chunk": ("ggp_tpu_torch/csrc/sgpr_adam.cu",
                     "ggp_tpu/ops/fused_sgpr.py:352"),
}
# Max relative error (norm-relative, see ``rel``). One evaluation: same
# algebra, another summation order and factorisation, ~1e-13 in float64 and
# ~1e-6 in float32.
TOL = {torch.float64: 1e-9, torch.float32: 1e-3}
# Adam divides each coordinate by its own RMS gradient, so a coordinate
# whose gradient is 1e-3 of the largest carries 1e-3 times the float32
# roundoff of the largest into its moments and step: ~1e-3 in float32 after
# 20 steps. In float64 the same effect stays below 1e-12.
ADAM_TOL = {torch.float64: 1e-8, torch.float32: 1e-2}
# A NUTS chunk integrates hundreds of leapfrog steps of a chaotic
# trajectory: the per-evaluation roundoff difference of the two versions
# (~1e-13 relative in f64, ~1e-6 in f32) grows along it, so draws are held
# to a looser bound than one evaluation. In f64 every tree decision of the
# chunk must agree. In f32 the grown difference reaches the margin of some
# multinomial or U-turn decision within a chunk, after which the two chains
# follow different (equally valid) paths; the check there is the leading
# run of transitions before the paths part, which must be non-empty.
NUTS_TOL = {torch.float64: 1e-6, torch.float32: 1e-2}


def make_data(seed=173):
    """bench.py ``_make_data("boston")`` in numpy: (X, y, Z) float64."""
    N, D = 506, 13
    rng = np.random.default_rng(seed)
    X_raw = rng.normal(size=(N, D))
    w = rng.normal(size=(D, 8)) / np.sqrt(D)
    f = np.cos(X_raw @ w + rng.uniform(0, 2 * np.pi, 8)).sum(1)
    y_raw = f + 0.3 * rng.normal(size=N)
    Xn, _, _ = normalize(X_raw)
    yn, _, _ = normalize(y_raw[:, None])
    n_train = int(0.8 * N)
    X = Xn[:n_train].astype(np.float32).astype(np.float64)
    y = yn[:n_train, 0].astype(np.float32).astype(np.float64)
    Z = X[rng.integers(0, n_train, 100)]
    return X, y, Z


def rel(a, b):
    """max |a - b| / max |b| (norm-relative: small entries of a gradient
    carry the absolute error of its largest ones)."""
    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


def abs_err(a, b):
    return float((torch.as_tensor(a).double() - torch.as_tensor(b).double()).abs().max())


def agreeing_prefix(d_k, d_p, x_k, x_p, tol):
    """Number of leading transitions of a NUTS chunk on which kernel and
    plain version agree: identical depth, leapfrog count and divergence,
    and draws within ``tol`` of the largest draw entry."""
    scale = float(d_p.abs().max())
    for t in range(d_p.shape[0]):
        if not torch.equal(x_k[t, 2:5], x_p[t, 2:5]) \
                or float((d_k[t] - d_p[t]).abs().max()) > tol * scale:
            return t
    return d_p.shape[0]


def cuda_ms(fn, reps):
    """Mean milliseconds per call on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_parity(Xd, yd, Zd):
    """Kernel against plain version. ``Zd`` holds distinct rows: bench.py's
    Z (drawn with replacement) repeats 8 rows, which puts Kmm pivots at the
    jitter level; there the Z-gradient along a duplicate pair's separation
    is roundoff, and Adam's normalised steps turn roundoff into lr-sized,
    implementation-dependent moves. The slice runs on bench.py's Z."""
    res = {k: {"rel": {}, "abs32": 0.0, "ms": None, "plain_ms": None} for k in KERNELS}
    for dt in (torch.float64, torch.float32):
        tag = "f64" if dt == torch.float64 else "f32"
        X, y, Z = Xd.to(dt), yd.to(dt), Zd.to(dt)
        n, d = X.shape
        jit = 1e-5                     # the float32 default jitter the slice runs
        thetas = [torch.zeros(d + 2, dtype=dt, device="cuda"),
                  torch.tensor([0.5] * d + [0.0, -2.0], dtype=dt, device="cuda")]

        # kernel 1: U and dU/dtheta (and dU/dZ under the trainers' options)
        errs, aerr = [], []
        for th in thetas:
            for kw in (dict(), dict(want_z_grad=True, want_prior=False, pivot_floor=1e-6)):
                out = vfe_potential(th, X, y, Z, jit, **kw)
                ref = rbf_vfe_neg_logpost_vg(th, X, y, Z, jit, **kw)
                errs += [rel(a, b) for a, b in zip(out, ref)]
                aerr += [abs_err(a, b) for a, b in zip(out, ref)]
        e = max(errs)
        print(f"parity vfe_potential {tag}: max rel err {e:.3e}")
        assert e <= TOL[dt], f"vfe_potential {tag} rel err {e}"
        th = thetas[0]
        ms = cuda_ms(lambda: vfe_potential(th, X, y, Z, jit), 20)
        pms = cuda_ms(lambda: rbf_vfe_neg_logpost_vg(th, X, y, Z, jit), 20)
        print(f"timing vfe_potential {tag}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
        res["vfe_potential"]["rel"][tag] = e
        if dt == torch.float32:
            res["vfe_potential"].update(abs32=max(aerr), ms=ms, plain_ms=pms)

        # kernel 2: one warm chunk and one sample chunk on shared slabs
        dim, K, md = d + 2, 16, 8
        gen = torch.Generator(device="cuda").manual_seed(5)
        U0, g0 = rbf_vfe_neg_logpost_vg(th, X, y, Z, jit)
        pot = lambda z: rbf_vfe_neg_logpost_vg(z, X, y, Z, jit)  # noqa: E731
        eps0 = find_reasonable_step_size(pot, th, U0, g0,
                                         torch.randn(dim, generator=gen, dtype=dt,
                                                     device="cuda"),
                                         torch.ones(dim, dtype=dt, device="cuda"), 0.1)
        zero = torch.zeros((), dtype=dt, device="cuda")
        st = ChainState(z=th, U=U0, g=g0, inv_mass=torch.ones(dim, dtype=dt, device="cuda"),
                        log_eps=torch.log(eps0), log_eps_avg=torch.log(eps0), h_avg=zero,
                        mu=torch.log(10.0 * eps0), t_da=zero,
                        wf_mean=torch.zeros(dim, dtype=dt, device="cuda"),
                        wf_m2=torch.zeros(dim, dtype=dt, device="cuda"), wf_count=zero)
        in_w = torch.arange(K, device="cuda") >= 4
        w_end = torch.arange(K, device="cuda") == 11
        errs, aerr, prefixes = [], [], []
        for adapt in (True, False):
            mom, treeu, leafu = draw_slabs(K, dim, md, gen, dtype=dt, device="cuda")
            kw = dict(mom=mom, treeu=treeu, leafu=leafu, n_active=K, adapt=adapt,
                      eps=torch.exp(st.log_eps_avg), in_window=in_w, window_end=w_end,
                      max_depth=md)
            t0 = time.perf_counter()
            s_k, d_k, x_k = nuts_chunk(st, X, y, Z, jit, **kw)
            torch.cuda.synchronize()
            t_k = time.perf_counter() - t0
            t0 = time.perf_counter()
            s_p, d_p, x_p = nuts_chunk_plain(st, X, y, Z, jit, **kw)
            torch.cuda.synchronize()
            t_p = time.perf_counter() - t0
            p = agreeing_prefix(d_k, d_p, x_k, x_p, NUTS_TOL[dt])
            prefixes.append(p)
            if p:
                errs += [rel(d_k[:p], d_p[:p]),
                         rel(x_k[:p][:, [0, 1, 5]], x_p[:p][:, [0, 1, 5]])]
                aerr += [abs_err(d_k[:p], d_p[:p]),
                         abs_err(x_k[:p][:, [0, 5]], x_p[:p][:, [0, 5]])]
            if p == K:          # same path to the end: the final state too
                errs += [rel(s_k.g, s_p.g), rel(s_k.U, s_p.U)]
                aerr += [abs_err(s_k.U, s_p.U), abs_err(s_k.g, s_p.g)]
            leaves = int(x_p[:, 4].sum())
            print(f"parity nuts_chunk {tag} adapt={adapt}: transitions on one path "
                  f"{p}/{K} (depth/n_leapfrog/diverging identical and draws within "
                  f"{NUTS_TOL[dt]:g}), leapfrogs {leaves}, max rel err over them "
                  f"{max(errs, default=float('nan')):.3e}, kernel {t_k * 1e3:.2f} ms, plain {t_p * 1e3:.2f} ms "
                  f"per chunk")
            if adapt:
                res["nuts_chunk"]["times"] = (t_k * 1e3, t_p * 1e3)
            st = s_p
        e = max(errs)
        if dt == torch.float64:
            assert prefixes == [K, K], f"nuts_chunk f64: paths part at {prefixes}"
        else:
            assert min(prefixes) >= 1, f"nuts_chunk f32: first transition differs {prefixes}"
        assert e <= NUTS_TOL[dt], f"nuts_chunk {tag} rel err {e}"
        res["nuts_chunk"]["rel"][tag] = e
        if dt == torch.float32:
            ms, pms = res["nuts_chunk"].pop("times")
            res["nuts_chunk"].update(abs32=max(aerr), ms=ms, plain_ms=pms)

        # kernels 3 and 4: parameters and losses after 20 steps
        zt, zz = torch.zeros_like(th), torch.zeros_like(Z)
        akw = dict(t0=0, num_steps=20, lr=0.01, clip_norm=10.0, min_noise=1e-4)
        out = sgpr_adam_chunk(th, Z, zt, zt, zz, zz, X, y, jit, **akw)
        ref = sgpr_adam_chunk_plain(th, Z, zt, zt, zz, zz, X, y, jit, **akw)
        e = max(rel(a, b) for a, b in zip(out, ref))
        print(f"parity sgpr_adam_chunk {tag}: max rel err {e:.3e}")
        assert e <= ADAM_TOL[dt], f"sgpr_adam_chunk {tag} rel err {e}"
        res["sgpr_adam_chunk"]["rel"][tag] = e
        ms = cuda_ms(lambda: sgpr_adam_chunk(th, Z, zt, zt, zz, zz, X, y, jit, **akw), 3)
        pms = cuda_ms(lambda: sgpr_adam_chunk_plain(th, Z, zt, zt, zz, zz, X, y, jit,
                                                    **akw), 1)
        print(f"timing sgpr_adam_chunk {tag} (20 steps): kernel {ms:.3f} ms, plain {pms:.3f} ms")
        if dt == torch.float32:
            res["sgpr_adam_chunk"].update(
                abs32=max(abs_err(a, b) for a, b in zip(out, ref)), ms=ms, plain_ms=pms)

        tgen = torch.Generator(device="cuda").manual_seed(7)
        trace = th + 0.1 * torch.randn((10, d + 2), generator=tgen, dtype=dt, device="cuda")
        zkw = dict(t0=0, num_steps=20, lr=0.01)
        out = z_adam_chunk(Z, zz, zz, trace, X, y, jit, **zkw)
        ref = z_adam_chunk_plain(Z, zz, zz, trace, X, y, jit, **zkw)
        e = max(rel(a, b) for a, b in zip(out, ref))
        print(f"parity z_adam_chunk {tag}: max rel err {e:.3e}")
        assert e <= ADAM_TOL[dt], f"z_adam_chunk {tag} rel err {e}"
        res["z_adam_chunk"]["rel"][tag] = e
        ms = cuda_ms(lambda: z_adam_chunk(Z, zz, zz, trace, X, y, jit, **zkw), 2)
        pms = cuda_ms(lambda: z_adam_chunk_plain(Z, zz, zz, trace, X, y, jit, **zkw), 1)
        print(f"timing z_adam_chunk {tag} (20 steps x 10 rows): kernel {ms:.3f} ms, "
              f"plain {pms:.3f} ms")
        if dt == torch.float32:
            res["z_adam_chunk"].update(
                abs32=max(abs_err(a, b) for a, b in zip(out, ref)), ms=ms, plain_ms=pms)
    return res


def min_ess_per_s(trace: np.ndarray, seconds: float) -> float:
    """bench.py ``_min_ess_per_s`` for a (S, dim) trace."""
    idx = np.unique(np.linspace(0, trace.shape[1] - 1,
                                min(trace.shape[1], 32)).astype(int))
    return min(effective_sample_size(trace[None, :, j]) for j in idx) / seconds


def phase_slice(Xd, yd, Zd):
    X, y, Z = (a.to(torch.float32) for a in (Xd, yd, Zd))
    model = BayesianSparseGPR_HMC(X, y, Z_init=Z)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rounds = [(100, 20), (25, 10), (25, 10), (100, 20)]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    losses = model.warm_start(num_steps=500, lr=0.01)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    print(f"slice warm_start: {t_warm:.3f} s, loss {float(losses[0]):.3f} -> "
          f"{float(losses[-1]):.3f}")
    assert torch.isfinite(losses).all() and float(losses[-1]) < float(losses[0])
    sampling, divs, accs, t_z = 0.0, [], [], 0.0
    for i, (tune, n) in enumerate(rounds):
        t0 = time.perf_counter()
        model.sample_hypers(tune, n, gen)
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        sampling += dt_s
        div = float(model.stats["diverging"].float().mean())
        acc = float(model.stats["accept_prob"].mean())
        divs.append(div)
        accs.append(acc)
        print(f"slice round {i} (tune={tune}, n={n}): {dt_s:.3f} s, divergence "
              f"fraction {div:.3f}, mean accept {acc:.3f}, step size "
              f"{float(model.stats['step_size']):.4g}, mean leapfrogs/draw "
              f"{float(model.stats['n_leapfrog'].mean()):.1f}")
        if i < len(rounds) - 1:
            t0 = time.perf_counter()
            zl = model.optimize_Z(num_steps=100, lr=0.01)
            torch.cuda.synchronize()
            t_z += time.perf_counter() - t0
            assert torch.isfinite(zl).all()
    t0 = time.perf_counter()
    means, vars_ = model.mixture_posterior_predictive(X)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"slice optimize_Z total: {t_z:.3f} s; predictive: {t_pred:.3f} s; "
          f"sampling total: {sampling:.3f} s")
    ess = min_ess_per_s(model.trace.double().cpu().numpy(), sampling)
    r = float(rmse(means.mean(0), y))
    nl = float(nlpd_mixture(means, vars_, y))
    print(f"slice min-ESS/s (last trace): {ess:.3f}; RMSE {r:.4f}; NLPD {nl:.4f}; "
          f"mixture components {means.shape[0]}")
    print(f"slice launches: {json.dumps(launches)}")
    assert all(v > 0 for v in launches.values()), launches
    assert max(divs) <= 0.1, f"divergence fraction {max(divs)}"
    assert float(np.mean(accs)) >= 0.5, f"mean accept {np.mean(accs)}"
    assert means.shape == (20, X.shape[0]) and vars_.shape == means.shape
    assert torch.isfinite(means).all() and torch.isfinite(vars_).all()
    assert math.isfinite(r) and math.isfinite(nl) and r < 1.0
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    X, y, Z = (torch.tensor(a, dtype=torch.float64, device="cuda") for a in make_data())
    distinct = np.random.default_rng(174).choice(X.shape[0], Z.shape[0], replace=False)
    res = phase_parity(X, y, X[torch.as_tensor(distinct, device="cuda")])
    launches = phase_slice(X, y, Z)
    out = []
    for name, (src, site) in KERNELS.items():
        r = res[name]
        out.append({"name": name, "route": "cuda", "source": src, "replaces": site,
                    "launches": launches[name], "max_abs_err": r["abs32"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "max_rel_err_f64": r["rel"]["f64"],
                    "max_rel_err_f32": r["rel"]["f32"]})
    out[1]["also_replaces"] = "ggp_tpu/ops/fused_nuts.py:792"
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
