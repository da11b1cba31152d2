"""BayesianSVGP: the "doubly stochastic" SVGP with a Gaussian variational
distribution over the log-hyperparameters (counterpart of
``ggp_tpu/models/bayesian_svgp.py``).

Besides q(v), SVI learns q(log theta) = N(hyper_mu, L_h L_h^T), L_h a
packed Cholesky factor (``hyper_L_vec``, exp diagonal). The hyper vector
has d+2 entries: theta[0] the log-outputscale, theta[1:-1] the ARD
log-lengthscales, theta[-1] the log noise std (log_noise = 2 theta[-1]);
d+1 without the noise slot for a classification likelihood. The prior is
N(0, prior_var I); the ELBO averages the data term over
``num_hyper_samples`` reparameterised draws per step.

``bsvgp_elbo`` is plain PyTorch, differentiable by autograd (the tests'
ground truth). ``train_model`` runs ``ops.svi.bsvgp_chunk``: whole epochs
of minibatch Adam steps per launch, each step on S fresh standard-normal
rows (S, h) from an explicit ``torch.Generator``. Training carries what the
JAX package fuses: the Gaussian likelihood, the Scale(RBF-ARD) kernel, S <=
8 and the built-in Adam; a Bernoulli-probit or Poisson model can be built
and predicted from (``mixture_predictive_proba``) but not trained, and
anything else raises ``NotImplementedError``. The predictive defaults to
theta = exp(s), consistent with training; ``transform="ref_softplus"``
reproduces the reference's exp(softplus(s)).
"""

from __future__ import annotations

import math

import torch

from ..config import default_jitter, resolve_device
from ..kernels import default_rbf
from ..likelihoods import BernoulliProbit, GaussianLikelihood, PoissonLogCox
from ..ops.svi import bsvgp_chunk
from .svgp import _build_L, _kl_whitened, _whitened_q_f, check_rbf_ard, epoch_chunks

__all__ = ["BayesianStochasticVariationalGP", "bsvgp_elbo"]

_MAX_DRAWS = 8


def _unpack_tril(vec: torch.Tensor, n: int) -> torch.Tensor:
    """Packed (n (n+1) / 2,) row-major lower triangle -> (n, n) with exp
    diagonal."""
    il = torch.tril_indices(n, n, device=vec.device)
    L = torch.zeros((n, n), dtype=vec.dtype, device=vec.device).index_put((il[0], il[1]), vec)
    return torch.tril(L, -1) + torch.diag(torch.exp(torch.diagonal(L)))


def _hyper_to_kernel_params(s: torch.Tensor, d: int, has_noise: bool = True):
    """One hyper sample -> (kernel params, log_noise or None)."""
    kp = {"log_outputscale": s[0], "base": {"log_lengthscale": s[1:d + 1]}}
    return kp, (2.0 * s[-1] if has_noise else None)


def _kl_hyper(q_mu, L_h, prior_var):
    """KL(N(q_mu, L L^T) || N(0, prior_var I))."""
    h = q_mu.shape[0]
    logdet = 2.0 * torch.log(torch.diagonal(L_h)).sum()
    return 0.5 * ((L_h * L_h).sum() / prior_var + (q_mu * q_mu).sum() / prior_var - h
                  - logdet + h * math.log(prior_var))


def bsvgp_elbo(kernel, likelihood, params: dict, X_batch, y_batch, num_data: int,
               num_hyper_samples: int, prior_var: float, jitter=None, eps=None,
               generator=None):
    """The doubly stochastic ELBO on hyper draws ``eps`` (S, h), drawn from
    ``generator`` when None."""
    jitter = default_jitter(X_batch.dtype) if jitter is None else jitter
    d = X_batch.shape[-1]
    has_noise = isinstance(likelihood, GaussianLikelihood)
    h = d + 2 if has_noise else d + 1
    L_h = _unpack_tril(params["hyper_L_vec"], h)
    if eps is None:
        eps = torch.randn((num_hyper_samples, h), generator=generator, dtype=X_batch.dtype,
                          device=X_batch.device)
    thetas = params["hyper_mu"][None] + eps @ L_h.T
    q_L = _build_L(params["q_sqrt_raw"])
    terms = []
    for s in thetas:
        kp, log_noise = _hyper_to_kernel_params(s, d, has_noise)
        mean, var = _whitened_q_f(kernel, kp, params["Z"], params["q_mu"], q_L, X_batch,
                                  jitter)
        lik_p = {"log_noise": log_noise} if has_noise else {}
        terms.append(likelihood.variational_expectation(lik_p, mean[:, 0], var[:, 0],
                                                        y_batch).sum())
    scale = num_data / X_batch.shape[0]
    return (scale * torch.stack(terms).mean() - _kl_whitened(params["q_mu"], q_L)
            - _kl_hyper(params["hyper_mu"], L_h, prior_var))


class BayesianStochasticVariationalGP:
    """``(train_x, train_y, likelihood, Z_init)`` constructor,
    ``train_model``, ``mixture_posterior_predictive`` and
    ``mixture_predictive_proba``."""

    def __init__(self, train_x, train_y, likelihood=None, Z_init=None, kernel=None,
                 prior_var: float = 0.01, num_hyper_samples: int = 5,
                 jitter: float | None = None, *, dtype=None, device=None):
        likelihood = GaussianLikelihood() if likelihood is None else likelihood
        unsupported = []
        if not check_rbf_ard(kernel):
            unsupported.append("kernels other than Scale(RBF-ARD)")
        if type(likelihood) not in (GaussianLikelihood, BernoulliProbit, PoissonLogCox):
            unsupported.append("likelihoods other than Gaussian, BernoulliProbit, "
                               "PoissonLogCox")
        if not 1 <= num_hyper_samples <= _MAX_DRAWS:
            unsupported.append(f"num_hyper_samples outside 1..{_MAX_DRAWS}")
        dtype = dtype or torch.as_tensor(train_x).dtype
        device = resolve_device("BayesianStochasticVariationalGP", device)
        self.train_x = torch.as_tensor(train_x, dtype=dtype, device=device).contiguous()
        self.train_y = torch.as_tensor(train_y, dtype=dtype, device=device).contiguous()
        d = self.train_x.shape[1]
        if d + 2 > 128:
            unsupported.append(f"d + 2 > 128 (got {d + 2})")
        if unsupported:
            raise NotImplementedError(
                "BayesianStochasticVariationalGP in the port takes Scale(RBF-ARD) with "
                f"S <= {_MAX_DRAWS}; still to port (ROADMAP queue 1 item 10): "
                + ", ".join(unsupported))
        self.kernel = default_rbf(ard=True)
        self.likelihood = likelihood
        self.jitter = default_jitter(dtype) if jitter is None else float(jitter)
        self.prior_var = prior_var
        self.num_hyper_samples = num_hyper_samples
        self._has_noise = type(likelihood) is GaussianLikelihood
        Z = self.train_x[:128] if Z_init is None else Z_init
        Z = torch.as_tensor(Z, dtype=dtype, device=device).clone().contiguous()
        M = Z.shape[0]
        h = d + 2 if self._has_noise else d + 1
        kw = dict(dtype=dtype, device=device)
        vec = torch.zeros(h * (h + 1) // 2, **kw)
        vec[torch.cumsum(torch.arange(1, h + 1), 0) - 1] = math.log(0.1)
        self.params = {"kernel": self.kernel.init_params(d, **kw), "Z": Z,
                       "q_mu": torch.zeros((M, 1), **kw),
                       "q_sqrt_raw": torch.zeros((1, M, M), **kw),
                       "hyper_mu": torch.zeros(h, **kw), "hyper_L_vec": vec}

    @property
    def hyper_dim(self) -> int:
        return self.train_x.shape[1] + (2 if self._has_noise else 1)

    def train_model(self, optimizer=None, num_epochs: int = 100, batch_size: int = 200,
                    lr: float = 0.01, generator: torch.Generator | None = None):
        """Minibatch Adam over ``num_epochs`` epochs (one permutation each),
        S = ``num_hyper_samples`` hyper draws per step; whole epochs run per
        kernel launch. Returns the per-epoch mean losses."""
        if optimizer is not None:
            raise NotImplementedError("a custom optimizer is still to port (ROADMAP "
                                      "queue 1 item 10): the kernels carry Adam")
        if not self._has_noise:
            raise NotImplementedError("training a BayesianSVGP with a non-Gaussian "
                                      "likelihood is still to port (ROADMAP queue 1 item 10)")
        X, y = self.train_x, self.train_y
        dev, dt = X.device, X.dtype
        h = self.hyper_dim
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        il = torch.tril_indices(h, h, device=dev)
        prm = self.params
        p = {"hmu": prm["hyper_mu"].clone(),
             "Lraw": torch.zeros((h, h), dtype=dt, device=dev).index_put(
                 (il[0], il[1]), prm["hyper_L_vec"]),
             "Z": prm["Z"].contiguous(), "q_mu": prm["q_mu"].contiguous(),
             "q_raw": prm["q_sqrt_raw"].contiguous()}
        mm = {k: torch.zeros_like(v) for k, v in p.items()}
        vv = {k: torch.zeros_like(v) for k, v in p.items()}
        t0, out = 0, []
        for ne, idx in epoch_chunks(X.shape[0], batch_size, num_epochs, generator, dev):
            K = idx.shape[0]
            eps = torch.randn((K, self.num_hyper_samples, h), generator=generator,
                              dtype=dt, device=dev)
            p, mm, vv, losses = bsvgp_chunk(p, mm, vv, X, y, idx, eps, self.jitter,
                                            prior_var=self.prior_var, t0=t0, lr=lr)
            out.append(losses.reshape(ne, -1).mean(1))
            t0 += K
        self.params = dict(prm, Z=p["Z"], q_mu=p["q_mu"], q_sqrt_raw=p["q_raw"],
                           hyper_mu=p["hmu"], hyper_L_vec=p["Lraw"][il[0], il[1]])
        return torch.cat(out)

    def mixture_posterior_predictive(self, test_x, num_samples: int = 100, generator=None,
                                     include_noise: bool = True, transform: str = "exp",
                                     eps=None):
        """Per-draw predictive moments over ``num_samples`` hyper draws
        ``eps`` (num_samples, h) from q(theta) (drawn from ``generator``,
        seed 1 when None, if not given); components with a non-finite moment
        are masked out. ``transform="ref_softplus"`` feeds softplus(s)
        through the exp-based forward, as the reference's predictive does."""
        if transform not in ("exp", "ref_softplus"):
            raise ValueError(f"transform must be 'exp' or 'ref_softplus', got {transform!r}")
        X = self.train_x
        test_x = torch.as_tensor(test_x, dtype=X.dtype, device=X.device)
        d, h = X.shape[1], self.hyper_dim
        L_h = _unpack_tril(self.params["hyper_L_vec"], h)
        if eps is None:
            if generator is None:
                generator = torch.Generator(device=X.device).manual_seed(1)
            eps = torch.randn((num_samples, h), generator=generator, dtype=X.dtype,
                              device=X.device)
        thetas = self.params["hyper_mu"][None] + eps @ L_h.T
        q_L = _build_L(self.params["q_sqrt_raw"])
        means, vars_ = [], []
        for s in thetas:
            if transform == "ref_softplus":
                s = torch.logaddexp(s, torch.zeros_like(s))
            kp, log_noise = _hyper_to_kernel_params(s, d, self._has_noise)
            mean, var = _whitened_q_f(self.kernel, kp, self.params["Z"], self.params["q_mu"],
                                      q_L, test_x, self.jitter)
            v = var[:, 0]
            if include_noise and self._has_noise:
                v = v + torch.exp(log_noise)
            means.append(mean[:, 0])
            vars_.append(v)
        means, vars_ = torch.stack(means), torch.stack(vars_)
        ok = torch.isfinite(means).all(-1) & torch.isfinite(vars_).all(-1)
        return means[ok], vars_[ok]

    def mixture_predictive_proba(self, test_x, num_samples: int = 100, generator=None,
                                 eps=None):
        """Per-draw P(y = 1 | x) under the exact probit integral, (S', Nt)."""
        if type(self.likelihood) is not BernoulliProbit:
            raise TypeError("mixture_predictive_proba requires a BernoulliProbit likelihood")
        means, vars_ = self.mixture_posterior_predictive(test_x, num_samples, generator,
                                                         include_noise=False, eps=eps)
        return torch.special.ndtr(means / torch.sqrt(1.0 + vars_))

    @property
    def Z(self):
        return self.params["Z"]
