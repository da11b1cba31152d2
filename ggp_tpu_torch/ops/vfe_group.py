"""The grouped cores: one evaluation spread over a group of G thread blocks
per chain, in one cooperative launch. The grouped vfe core
(``csrc/vfe_group.cuh``, ``VfeGroupCore``) computes the collapsed bound,
the grouped sgpmc core (``csrc/sgpmc_group.cuh``, ``SgpmcGroupCore``) the
whitened JointHMC potential. The potential kernel, the NUTS chunk kernel
and the HMC chunk kernel run the vfe group where the JAX package streams
its core: past 1024 rows for C >= 2 chains
(``fused_multichain.MAX_N_MULTICHAIN``), past 2048 for one chain
(``fused_nuts.MAX_N_RESIDENT``); below that the one-block vfe core runs.
They run the sgpmc group at every n, where it is faster than one block per
chain at every (n, C) measured (PERF.md). The grouped trainers run the vfe
group past 2048 rows (``csrc/sgpr_adam.cu``, ``ops/sgpr_adam.py``) and the
sgpmc group at every n (``csrc/sgpmc_warm.cu``, ``ops/sgpmc_warm.py``). The
dense gpr core (``csrc/gpr_bound.cuh``, ``GprGroupCore``) runs on a group at
every n.

Here is what a launch needs and the CPU can check: the routing rule
(:func:`route`), the launch geometry (:func:`group_size`, :func:`row_blocks`,
:func:`geometry`), the scratch of a launch (:func:`launch_work`,
:func:`group_scratch`, sized by the C side), and plain models of the
kernels' summation order (row-block partials summed p = 0 .. G-1, then the
M x M part): :func:`group_neg_logpost_vg`, the function of
``vfe_bound.rbf_vfe_neg_logpost_vg``, and :func:`sgpmc_group_neg_logpost_vg`,
that of ``sgpmc_bound.sgpmc_neg_logpost_vg``. The gpr core's plain model is
``ops.gpr_bound.gpr_group_neg_logpost_vg``.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .linalg import capped_inv_ls, chol_upper

__all__ = ["route", "group_size", "row_blocks", "blocks_per_sm", "geometry", "group_scratch",
           "launch_work", "group_neg_logpost_vg", "sgpmc_group_neg_logpost_vg",
           "GROUP_MIN_N", "GROUP_MIN_N_MC"]

# The JAX package's streaming thresholds, kept as the switch between the two
# vfe designs; per evaluation the vfe group is faster at every n measured
# (1279 to 13,279, PERF.md), the NUTS chunk's crossover is not measured.
GROUP_MIN_N = 2048            # one chain: the grouped vfe core past this many rows
GROUP_MIN_N_MC = 1024         # C >= 2 chains
_BAR_WORDS = 32               # csrc/vfe_group.cuh kBarWords: one chain's barrier
_OCCUPANCY: dict = {}


def route(core: str, n: int, chains: int) -> str:
    """The core whose kernel runs ``core`` on n rows for ``chains`` chains,
    for every sampler kernel (potential, NUTS and HMC chunks): ``"vfe_group"``
    where the JAX package streams the vfe core (n > 1024 with C >= 2 chains,
    n > 2048 with one); ``"sgpmc_group"`` for the sgpmc core at every n
    (``_build.GROUP_ONLY``: it has no one-block kernel); else ``core`` itself
    (the gpr core is grouped at every n)."""
    if core in _build.GROUP_ONLY:
        return _build.GROUP_ONLY[core]
    if core == "vfe" and n > (GROUP_MIN_N_MC if chains >= 2 else GROUP_MIN_N):
        return "vfe_group"
    return core


def group_size(chains: int, sm_count: int, blocks_per_sm: int) -> int:
    """G, the blocks of each chain's group: the blocks the card holds at
    once (``sm_count`` SMs of ``blocks_per_sm``, the kernel's occupancy),
    shared equally among the chains. Raises where that leaves a chain no
    block: the cooperative launch needs every block resident at once."""
    G = (sm_count * blocks_per_sm) // chains
    if G < 1:
        raise RuntimeError(f"a grouped core needs a block per chain: {chains} chains "
                           f"on {sm_count} SMs of {blocks_per_sm} resident blocks")
    return G


def row_blocks(n: int, G: int) -> list[tuple[int, int]]:
    """(first row, rows) of each block p of G: contiguous, their sizes
    within one of each other, together [0, n) once (``row_begin`` of
    ``csrc/row_blocks.cuh``)."""
    b = [n * p // G for p in range(G + 1)]
    return [(b[p], b[p + 1] - b[p]) for p in range(G)]


def blocks_per_sm(kind: str, dtype: torch.dtype, core: str = "vfe_group") -> int:
    """Blocks of the grouped ``kind`` kernel ("potential", "nuts_chunk",
    "hmc_chunk"; or "sgpr_adam" for the grouped trainer) of ``core`` that one SM holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at its block
    size; registers and shared memory decide it)."""
    key = (kind, dtype, core)
    if key not in _OCCUPANCY:
        fn = getattr(_build.build(), f"ggp_{kind}_{core}_occupancy")
        bps = int(fn(int(dtype == torch.float64)))
        if bps < 0:
            raise RuntimeError(f"{core} {kind}: occupancy query failed with cudaError_t {-bps}")
        _OCCUPANCY[key] = bps
    return _OCCUPANCY[key]


def geometry(kind: str, dtype: torch.dtype, chains: int, device, core: str = "vfe_group",
             n: int | None = None) -> int:
    """G for one launch of the grouped ``kind`` kernel of ``core`` on
    ``chains`` chains of n rows: :func:`group_size` from the card's SM count
    and :func:`blocks_per_sm`; for the sgpmc group at most n, so that no
    block is left without rows. More blocks are no slower down to a few
    rows each: the G sweep at N=404 (chip_smoke.py's sweep, PERF.md; H100,
    f32) found every sgpmc kernel the paths run fastest at the most blocks
    the card holds, ~3 rows a block (the NUTS chunk 0.589 .. 0.457 ms a
    leapfrog at G = 8 .. 132)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    G = group_size(chains, sms, blocks_per_sm(kind, dtype, core))
    return min(G, n) if core == "sgpmc_group" and n is not None else G


def group_scratch(n: int, m: int, d: int, C: int, G: int, like: torch.Tensor,
                  core: str = "vfe_group") -> torch.Tensor:
    """One launch's scratch of a grouped core (the count from the C side),
    its C barriers zeroed, the rest uninitialised."""
    f64 = int(like.dtype == torch.float64)
    lib = _build.build()
    if core == "gpr":
        elems = lib.ggp_gpr_scratch_elems(n, d, C, G, f64)
    elif core == "sgpmc_group":         # with G full M x M partials a chain
        elems = lib.ggp_sgpmc_group_scratch_elems(n, m, d, C, G, f64)
    else:
        elems = lib.ggp_group_scratch_elems(n, m, d, C, G, f64)
    elems = int(elems)
    work = torch.empty(elems, dtype=like.dtype, device=like.device)
    work[:C * _BAR_WORDS * 4 // like.element_size()].zero_()
    return work


def launch_work(kind: str, core: str, n: int, m: int, d: int, C: int,
                like: torch.Tensor, G: int | None = None) -> tuple[torch.Tensor, dict]:
    """The scratch of one launch of the ``kind`` kernel of ``core`` on C
    chains, and the cfg entries its geometry adds: for a grouped core
    (``_build.GROUPED``) G (cfg slot GROUP: ``G`` where the caller forces
    one, else :func:`geometry`) and :func:`group_scratch`; for any other
    core one evaluation's area per chain (``_build.scratch``) and none."""
    if core not in _build.GROUPED:
        return _build.scratch(n, m, d, 0, like, chains=C, core=core), {}
    if G is None:
        G = geometry(kind, like.dtype, C, like.device, core=core, n=n)
    return group_scratch(n, m, d, C, G, like, core=core), {"GROUP": G}


def _in_order(parts):
    """sum of ``parts`` in the order p = 0, 1, ..."""
    acc = torch.zeros_like(parts[0])
    for q in parts:
        acc = acc + q
    return acc


def group_neg_logpost_vg(theta, X, y, Z, jitter, G, *, want_z_grad=False, want_prior=True,
                         pivot_floor=None, prior_spec=None):
    """The grouped core's evaluation in its own order, plain PyTorch: the
    rows cut by :func:`row_blocks` into G blocks; each block's partials of
    B - I, u, y^T y (pass 1) and of |alpha|^2, sum Pnm, the column sums of
    QnmX and GnmZ (pass 2) in float64; the partials summed p = 0 .. G-1; the
    M x M part of ``collapsed_bound`` between. Returns U, dU/dtheta
    (, dU/dZ) as ``rbf_vfe_neg_logpost_vg`` does."""
    from .vfe_bound import _tri, prior_terms
    n, d = X.shape
    m = Z.shape[0]
    dt, f64 = X.dtype, torch.float64
    eye = torch.eye(m, dtype=dt, device=X.device)
    inv_ls = capped_inv_ls(theta[:d], X, Z)
    sf2, s2 = torch.exp(theta[d]), torch.exp(theta[d + 1])
    sigma, js = torch.sqrt(s2), torch.clamp(sf2, min=1.0)
    Zs = Z * inv_ls
    zn = (Zs * Zs).sum(1)
    Kmm = sf2 * torch.exp(-0.5 * torch.clamp(zn[:, None] + zn[None] - 2.0 * Zs @ Zs.T, min=0.0))
    U = chol_upper(Kmm + (jitter * js) * eye, None if pivot_floor is None else pivot_floor * js)
    V = torch.linalg.solve_triangular(U, eye, upper=True)                 # L^-T
    blocks = row_blocks(n, G)

    def grams(r0, nr):
        Xs = X[r0:r0 + nr] * inv_ls
        xn = (Xs * Xs).sum(1)
        Knm = sf2 * torch.exp(-0.5 * torch.clamp(xn[:, None] + zn[None] - 2.0 * Xs @ Zs.T,
                                                 min=0.0))
        return Xs, Knm, Knm @ V / sigma

    one = []                                   # pass 1, per block
    for r0, nr in blocks:
        An = grams(r0, nr)[2].to(f64)
        yb = y[r0:r0 + nr].to(f64)
        one.append((An.T @ An, An.T @ yb, (yb * yb).sum()))
    B = _in_order([q[0] for q in one]).to(dt) + eye
    u = _in_order([q[1] for q in one]).to(dt)
    yy = _in_order([q[2] for q in one]).to(dt)

    # the M x M part (collapsed_mm)
    UB = chol_upper(B, pivot_floor)
    VB = torch.linalg.solve_triangular(UB, eye, upper=True)
    Binv = VB @ VB.T
    c = _tri(UB, u, trans=True)
    v = _tri(UB, c)
    w = _tri(U, v)
    logdetB = 2.0 * torch.log(torch.diagonal(UB)).sum()
    t_term = n * sf2 - s2 * (torch.diagonal(B).sum() - m)
    F = (-0.5 * n * torch.log(2.0 * math.pi * s2) - 0.5 * logdetB
         - 0.5 * (yy - (c * c).sum()) / s2 - 0.5 * t_term / s2)
    Y1 = (eye - Binv) @ V.T
    dKmm = -torch.outer(w, w) / (2.0 * s2) + 0.5 * (V @ (2.0 * eye - B - Binv)) @ V.T
    Pmm = dKmm * Kmm
    dzz = Zs[:, None, :] - Zs[None, :, :]                               # zs_a - zs_b
    GmmZ = (Pmm[..., None] * dzz).sum(1)
    QmmZ = (Pmm[..., None] * dzz * dzz).sum(1)

    two = []                                   # pass 2, per block
    for r0, nr in blocks:
        Xs, Knm, An = grams(r0, nr)
        alpha = (y[r0:r0 + nr] - An @ v) / s2
        Pnm = (An @ Y1 + alpha[:, None] * w[None]) / sigma * Knm
        dzx = Zs[None, :, :] - Xs[:, None, :]                           # zs_a - xs_i
        two.append(((alpha.to(f64) ** 2).sum(), Pnm.to(f64).sum(),
                    (Pnm[..., None] * dzx * dzx).sum(1).to(f64).sum(0),
                    (Pnm.to(f64)[..., None] * dzx.to(f64)).sum(0)))
    aa, S_nm, Qnm, GnmZ = (_in_order([q[i] for q in two]).to(dt) for i in range(4))

    dls = Qnm + QmmZ.sum(0)
    dlog_os = (Pmm.sum() + S_nm + jitter * sf2 * (sf2 > 1.0).to(dt) * torch.diagonal(dKmm).sum()
               - n * sf2 / (2.0 * s2))
    trW = (n - m + torch.diagonal(Binv).sum()) / s2
    dlog_noise = (0.5 * aa - 0.5 * trW + t_term / (2.0 * s2 * s2)) * s2
    g = torch.cat([dls, dlog_os[None], dlog_noise[None]])
    if want_prior:
        lp, gp = prior_terms(theta, d, prior_spec)
        F = F + lp
        g = g + gp
    if not want_z_grad:
        return -F, -g
    return -F, -g, (2.0 * GmmZ + GnmZ) * inv_ls


def sgpmc_group_neg_logpost_vg(state, X, y, Z, jitter, G, *, want_z_grad=False, want_prior=True,
                               pivot_floor=None):
    """The grouped sgpmc core's evaluation in its own order, plain PyTorch:
    V = L^-T from the factor of Kmm; the rows cut by :func:`row_blocks` into
    G blocks, each giving, from At_b = Knm_b V, e_b, the clamped variance and
    its mask, Abar_b^T and Pms_b^T = (Abar_b^T V^T) o Knm_b, its partials in
    float64 (see, svar, sum msk, sum Pms, A e, T = Abar A^T in full, the
    column sums of Pms^T, cs^T Xs^2, Pms Xs); the partials summed p = 0 ..
    G-1 and cast to the working type; then the M x M epilogue (Phi = T o
    (strict lower + I / 2), Kmm_b = -V Phi V^T symmetrised) and, with
    ``want_z_grad``, dU/dZ from Pmm's row sums, Pmm Zs and the summed column
    sums of Pms^T and Pms Xs. Returns U and dU/dstate (, dU/dZ) as
    ``sgpmc_neg_logpost_vg`` does."""
    n, d = X.shape
    m = Z.shape[0]
    dt, f64 = X.dtype, torch.float64
    eye = torch.eye(m, dtype=dt, device=X.device)
    v = state[d + 2:]
    inv_ls = capped_inv_ls(state[:d], X, Z)
    sf2, s2 = torch.exp(state[d]), torch.exp(state[d + 1])
    js = torch.clamp(sf2, min=1.0)
    Zs = Z * inv_ls
    zn = (Zs * Zs).sum(1)
    Kmm = sf2 * torch.exp(-0.5 * torch.clamp(zn[:, None] + zn[None] - 2.0 * Zs @ Zs.T, min=0.0))
    U = chol_upper(Kmm + (jitter * js) * eye, None if pivot_floor is None else pivot_floor * js)
    V = torch.linalg.solve_triangular(U, eye, upper=True)                 # L^-T

    def wide(a):
        return a.to(f64)

    parts = []
    for r0, nr in row_blocks(n, G):
        Xs = X[r0:r0 + nr] * inv_ls
        xn = (Xs * Xs).sum(1)
        Knm = sf2 * torch.exp(-0.5 * torch.clamp(xn[:, None] + zn[None] - 2.0 * Xs @ Zs.T,
                                                 min=0.0))
        At = Knm @ V
        e = y[r0:r0 + nr] - At @ v
        var_raw = sf2 - (At * At).sum(1)
        msk = (var_raw > 1e-12).to(dt)
        var = torch.clamp(var_raw, min=1e-12)
        Ab = (e[:, None] * v[None] + At * msk[:, None]) / s2
        Pms = (Ab @ V.T) * Knm
        cs = Pms.sum(1)
        parts.append(torch.cat([
            torch.stack([(wide(e) ** 2).sum(), wide(var).sum(), wide(msk).sum(), wide(cs).sum()]),
            wide(At).T @ wide(e), (wide(Ab).T @ wide(At)).reshape(-1), wide(Pms).sum(0),
            wide(cs) @ wide(Xs) ** 2, (wide(Pms).T @ wide(Xs)).reshape(-1)]))
    tot = _in_order(parts).to(dt)
    see, svar, smsk, spms = tot[:4]
    ae, T = tot[4:4 + m], tot[4 + m:4 + m + m * m].reshape(m, m)
    o = 4 + m + m * m
    rs_ms, csX2, PmsX = tot[o:o + m], tot[o + m:o + m + d], tot[o + m + d:].reshape(m, d)

    F = -0.5 * n * torch.log(2.0 * math.pi * s2) - 0.5 * (see + svar) / s2 - 0.5 * (v * v).sum()
    pr = 1.0 if want_prior else 0.0
    if want_prior:
        hyp = state[:d + 2]
        F = F + (2.0 * hyp - torch.exp(hyp)).sum()
    g_v = ae / s2 - v
    Phi = torch.tril(T, -1) + 0.5 * torch.diag(torch.diagonal(T))
    Kb = -(V @ Phi) @ V.T
    Kb = 0.5 * (Kb + Kb.T)
    Pmm = Kb * Kmm
    dF_ds2 = -0.5 * n / s2 + 0.5 * (see + svar) / (s2 * s2)
    dlog_noise = dF_ds2 * s2 + pr * (2.0 - s2)
    dlog_os = (Pmm.sum() + spms + jitter * sf2 * (sf2 > 1.0).to(dt) * torch.diagonal(Kb).sum()
               - 0.5 * smsk * sf2 / s2 + pr * (2.0 - sf2))
    dls = ((2.0 * Pmm.sum(1) + rs_ms) @ (Zs * Zs) + csX2
           - 2.0 * (Zs * (Pmm @ Zs + PmsX)).sum(0))
    g_ls = dls + pr * (2.0 - torch.exp(state[:d]))
    out = (-F, -torch.cat([g_ls, dlog_os[None], dlog_noise[None], g_v]))
    if not want_z_grad:
        return out
    dzs = -2.0 * (Pmm.sum(1)[:, None] * Zs - Pmm @ Zs) - (rs_ms[:, None] * Zs - PmsX)
    return out + (-(dzs * inv_ls),)
