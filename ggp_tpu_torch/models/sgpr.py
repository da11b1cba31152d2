"""SGPR: the Titsias collapsed bound, its statistics form, the predictive
and ``SparseGPR`` (counterpart of ``ggp_tpu/models/sgpr.py``).

``sgpr_elbo`` is the autograd reference the hand-derived bound and its
kernels are tested against; ``sgpr_predict`` serves the mixture
predictives; ``vfe_stats`` and ``sgpr_elbo_from_stats`` are the big-N form
SGHMC samples with (the statistics are additive over rows, so a minibatch
scaled by N/B estimates the full-data ones).

  L  = chol(Kmm + jitter I),  A = L^-1 Kmn / sigma,  B = I + A A^T
  c  = LB^-1 A y / sigma
  ELBO = -N/2 log(2 pi s2) - sum log diag LB - (y^T y / s2 - c^T c)/2
         - (sum k_diag - s2 ||A||_F^2) / (2 s2)

``SparseGPR`` trains (hypers, Z) by Adam with the whole chunk of steps in
one launch of ``ops.sgpr_adam.sgpr_adam_chunk`` on the card (its plain
version on CPU tensors).
"""

from __future__ import annotations

import math

import torch

from ..config import default_jitter, resolve_device
from ..kernels import Kernel, default_rbf, is_scale_rbf
from ..likelihoods import GaussianLikelihood
from ..ops.linalg import safe_cholesky, tri_solve
from ..ops.sgpr_adam import sgpr_adam_chunk
from ..ops.vfe_stats import stationary_vfe_stats
from ..utils.tree import tree_map
from .svgp import check_rbf_ard

__all__ = ["sgpr_elbo", "sgpr_predict", "sgpr_optimal_qu", "vfe_stats",
           "sgpr_elbo_from_stats", "SparseGPR"]


def _common(kernel: Kernel, params: dict, X: torch.Tensor, y: torch.Tensor,
            jitter: float):
    """Shared factorisation for the bound and the predictive."""
    Z = params["Z"]
    kp = params["kernel"]
    sigma2 = torch.exp(params["log_noise"])
    sigma = torch.sqrt(sigma2)
    Kmm = kernel.gram(kp, Z, Z)
    Kmn = kernel.gram(kp, Z, X)
    L = safe_cholesky(Kmm, jitter, relative=True)
    A = tri_solve(L, Kmn) / sigma
    B = A @ A.T + torch.eye(Z.shape[0], dtype=X.dtype, device=X.device)
    LB = safe_cholesky(B, 0.0)
    c = tri_solve(LB, A @ y) / sigma
    return dict(Z=Z, kp=kp, sigma2=sigma2, L=L, A=A, LB=LB, c=c)


def sgpr_elbo(kernel: Kernel, params: dict, X: torch.Tensor, y: torch.Tensor,
              jitter: float) -> torch.Tensor:
    """Collapsed VFE bound, total over the N rows."""
    n = X.shape[0]
    f = _common(kernel, params, X, y, jitter)
    sigma2, A, LB, c = f["sigma2"], f["A"], f["LB"], f["c"]
    kdiag_sum = kernel.diag(f["kp"], X).sum()
    qdiag_sum = sigma2 * (A * A).sum()
    bound = -0.5 * n * torch.log(2.0 * math.pi * sigma2)
    bound = bound - torch.log(torch.diagonal(LB)).sum()
    bound = bound - 0.5 * ((y * y).sum() / sigma2 - (c * c).sum())
    return bound - 0.5 * (kdiag_sum - qdiag_sum) / sigma2


def sgpr_predict(kernel: Kernel, params: dict, X: torch.Tensor, y: torch.Tensor,
                 X_test: torch.Tensor, jitter: float, full_cov: bool = False,
                 include_noise: bool = True):
    """Posterior predictive at ``X_test``: mean and marginal variance, or the
    full covariance with ``full_cov`` (plus the observation noise when
    ``include_noise``)."""
    f = _common(kernel, params, X, y, jitter)
    Kts = kernel.gram(f["kp"], f["Z"], X_test)
    tmp1 = tri_solve(f["L"], Kts)
    tmp2 = tri_solve(f["LB"], tmp1)
    mean = tmp2.T @ f["c"]
    if full_cov:
        cov = kernel.gram(f["kp"], X_test, X_test) - tmp1.T @ tmp1 + tmp2.T @ tmp2
        if include_noise:
            cov = cov + f["sigma2"] * torch.eye(X_test.shape[0], dtype=X.dtype,
                                                device=X.device)
        return mean, cov
    var = (kernel.diag(f["kp"], X_test) - (tmp1 * tmp1).sum(0)
           + (tmp2 * tmp2).sum(0))
    var = torch.clamp(var, min=1e-12)
    if include_noise:
        var = var + f["sigma2"]
    return mean, var


def sgpr_optimal_qu(kernel: Kernel, params: dict, X: torch.Tensor, y: torch.Tensor,
                    jitter: float):
    """The optimal q*(u) = N(m_u, S_u): m_u = L LB^-T c, S_u = L B^-1 L^T."""
    f = _common(kernel, params, X, y, jitter)
    m_u = f["L"] @ tri_solve(f["LB"], f["c"], trans=True)
    tmp = tri_solve(f["LB"], f["L"].T)
    return m_u, tmp.T @ tmp


def vfe_stats(kernel: Kernel, kp: dict, Z: torch.Tensor, X: torch.Tensor,
              y: torch.Tensor, idx: torch.Tensor | None = None) -> dict:
    """The four additive statistics of the collapsed bound over the rows of X
    (or the rows ``idx`` of X): S_kk = Kmn Knm, S_ky = Kmn y, s_kdiag =
    sum k(x, x), s_yy = y^T y. Scale(RBF) goes to
    :func:`ops.vfe_stats.stationary_vfe_stats` (kernels 10 and 11 on the
    card, C chains when the kernel parameters carry a leading chain
    dimension); any other kernel forms the gram in plain PyTorch (one
    chain)."""
    if is_scale_rbf(kernel):
        return stationary_vfe_stats(X, y, Z, kp["base"]["log_lengthscale"],
                                    kp["log_outputscale"], fam="rbf", idx=idx)
    if idx is not None:
        X, y = X[idx], y[idx]
    Kmn = kernel.gram(kp, Z, X)
    return {"S_kk": Kmn @ Kmn.T, "S_ky": Kmn @ y,
            "s_kdiag": kernel.diag(kp, X).sum(), "s_yy": (y * y).sum()}


def sgpr_elbo_from_stats(kernel: Kernel, params: dict, stats: dict, n: int,
                         jitter: float | None = None, f64_core: bool = False) -> torch.Tensor:
    """The collapsed bound from :func:`vfe_stats` (the value of
    :func:`sgpr_elbo` up to roundoff; the statistics form squares the
    condition number of Kmn). Batched over a leading chain dimension of the
    parameters and statistics. ``f64_core`` runs the M x M epilogue (the
    grams, factorisations and solves) in float64 whatever the input dtype.
    A factorisation that fails gives NaN, not an error."""
    Z = params["Z"]
    if jitter is None:
        jitter = default_jitter(Z.dtype)
    if f64_core:
        stats = {k: v.to(torch.float64) for k, v in stats.items()}
        params = tree_map(lambda a: a.to(torch.float64), params)
        Z = params["Z"]
    sigma2 = torch.exp(params["log_noise"])
    M = Z.shape[-2]
    L = safe_cholesky(kernel.gram(params["kernel"], Z, Z), jitter, relative=True)
    T = tri_solve(L, stats["S_kk"])
    AAt = tri_solve(L, T.transpose(-1, -2)).transpose(-1, -2) / sigma2[..., None, None]
    B = AAt + torch.eye(M, dtype=AAt.dtype, device=AAt.device)
    LB = safe_cholesky(B, 0.0)
    Ay = tri_solve(L, stats["S_ky"]) / torch.sqrt(sigma2)[..., None]
    c = tri_solve(LB, Ay) / torch.sqrt(sigma2)[..., None]
    bound = -0.5 * n * torch.log(2.0 * math.pi * sigma2)
    bound = bound - torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)).sum(-1)
    bound = bound - 0.5 * (stats["s_yy"] / sigma2 - (c * c).sum(-1))
    trace = torch.diagonal(AAt, dim1=-2, dim2=-1).sum(-1)
    return bound - 0.5 * (stats["s_kdiag"] - sigma2 * trace) / sigma2


class SparseGPR:
    """``(train_x, train_y, likelihood, Z_init, kernel, jitter)`` constructor
    (the JAX package's order), ``train_model``, ``posterior_predictive``,
    ``optimal_q_u``, ``Z`` and ``noise``. Takes Scale(RBF-ARD) x Gaussian.
    The model's tensors live on the card unless ``device="cpu"``."""

    def __init__(self, train_x, train_y, likelihood=None, Z_init=None, kernel=None,
                 jitter: float | None = None, *, dtype=None, device=None):
        unsupported = []
        if likelihood is not None and type(likelihood) is not GaussianLikelihood:
            unsupported.append("non-Gaussian likelihoods")
        if not check_rbf_ard(kernel):
            unsupported.append("kernels other than Scale(RBF-ARD)")
        if unsupported:
            raise NotImplementedError(
                "SparseGPR in the port takes Scale(RBF-ARD) x Gaussian; still to port "
                "(ROADMAP queue 1 item 4, the autograd trainer): " + ", ".join(unsupported))
        dtype = dtype or torch.as_tensor(train_x).dtype
        device = resolve_device("SparseGPR", device)
        self.train_x = torch.as_tensor(train_x, dtype=dtype, device=device).contiguous()
        self.train_y = torch.as_tensor(train_y, dtype=dtype, device=device).contiguous()
        d = self.train_x.shape[1]
        self.kernel = default_rbf(ard=True) if kernel is None else kernel
        self.likelihood = GaussianLikelihood()
        self.jitter = default_jitter(dtype) if jitter is None else float(jitter)
        Z = self.train_x[:128] if Z_init is None else Z_init
        kw = dict(dtype=dtype, device=device)
        self.params = {"kernel": self.kernel.init_params(d, **kw),
                       "log_noise": torch.zeros((), **kw),
                       "Z": torch.as_tensor(Z, **kw).clone().contiguous()}

    def loss_fn(self, params):
        return -sgpr_elbo(self.kernel, params, self.train_x, self.train_y, self.jitter)

    def _theta(self):
        kp = self.params["kernel"]
        return torch.cat([kp["base"]["log_lengthscale"], kp["log_outputscale"].reshape(1),
                          self.params["log_noise"].reshape(1)]).contiguous()

    def train_model(self, optimizer=None, max_steps: int = 2000, lr: float = 0.01,
                    log_interval: int = 1000, verbose: bool = True):
        """Adam on (theta, Z) of -ELBO with the JAX package's fused
        trainer's chain: masked gradient, clip by global norm 100, Adam, a
        +-15 box on the log-hypers and the noise floor 1e-4; chunks of 200
        steps per launch plus one remainder. Returns the per-step losses."""
        if optimizer is not None:
            raise NotImplementedError("a custom optimizer is still to port (ROADMAP queue 1 "
                                      "item 4): the kernel carries Adam")
        d = self.train_x.shape[1]
        theta, Z = self._theta(), self.params["Z"]
        m_th, v_th = torch.zeros_like(theta), torch.zeros_like(theta)
        m_z, v_z = torch.zeros_like(Z), torch.zeros_like(Z)
        K = min(int(max_steps), 200)
        n_full, rem = divmod(int(max_steps), K) if K else (0, 0)
        chunks = [K] * n_full + ([rem] if rem else [])
        losses, t0 = [], 0
        for k in chunks:
            theta, Z, m_th, v_th, m_z, v_z, l = sgpr_adam_chunk(
                theta, Z, m_th, v_th, m_z, v_z, self.train_x, self.train_y, self.jitter,
                t0=t0, num_steps=k, lr=lr, clip_norm=100.0, min_noise=1e-4)
            losses.append(l)
            t0 += k
        self.params = {"kernel": {"base": {"log_lengthscale": theta[:d].clone()},
                                  "log_outputscale": theta[d].clone()},
                       "log_noise": theta[d + 1].clone(), "Z": Z}
        losses = torch.cat(losses) if losses else theta.new_zeros(0)
        if verbose and log_interval:
            for j in range(0, int(max_steps), log_interval):
                print(f"Iter {j}/{max_steps} - Loss: {float(losses[j]):.3f}")
        return losses

    def posterior_predictive(self, test_x, full_cov: bool = True, include_noise: bool = True):
        test_x = torch.as_tensor(test_x, dtype=self.train_x.dtype, device=self.train_x.device)
        return sgpr_predict(self.kernel, self.params, self.train_x, self.train_y, test_x,
                            self.jitter, full_cov=full_cov, include_noise=include_noise)

    def optimal_q_u(self):
        return sgpr_optimal_qu(self.kernel, self.params, self.train_x, self.train_y,
                               self.jitter)

    @property
    def Z(self):
        return self.params["Z"]

    @property
    def noise(self):
        return torch.exp(self.params["log_noise"])

