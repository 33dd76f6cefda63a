"""Exact (single-block) Gaussian process regression.

Batched-JAX equivalent of treegp's ``gp.GP`` as used by the reference for
predictive scoring (``gprfopt.py:100-118``, ``prediction_error_gp``): train
on (X, y) with a GPCov + noise variance, predict means and covariances at
test inputs.  One Cholesky factorization on device; no cover trees needed —
dense masked math covers reference scales.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import jax.scipy.linalg as jsp_linalg

from gprf_tpu.kernels.covfn import cross_kernel_matrix, kernel_matrix
from gprf_tpu.kernels.gpcov import GPCov


class GP:
    """Exact GP with zero prior mean.

    Mirrors the treegp ``gp.GP(X, y, cov_main, noise_var, ...)`` surface the
    reference relies on: ``predict``, ``covariance``, ``factor``, and a
    mutable ``y`` / ``alpha_r`` pair (the reference swaps output columns in
    place at ``gprfopt.py:106-109``).
    """

    def __init__(self, X, y, cov_main: GPCov, noise_var, **_ignored):
        self.X = np.asarray(X, dtype=np.float64)
        self.cov_main = cov_main
        self.noise_var = float(noise_var)
        K = np.asarray(
            kernel_matrix(cov_main, jnp.asarray(self.X), noise_var=self.noise_var)
        )
        self._L = np.asarray(jsp_linalg.cholesky(jnp.asarray(K), lower=True))
        self.y = np.asarray(y).reshape(len(self.X), -1)
        self.alpha_r = self.factor(self.y)

    def factor(self, y):
        """K^-1 y via the cached Cholesky factor."""
        y = np.asarray(y).reshape(len(self.X), -1)
        a = np.asarray(
            jsp_linalg.cho_solve((jnp.asarray(self._L), True), jnp.asarray(y))
        )
        return a

    def kernel(self, X1, X2):
        return np.asarray(
            cross_kernel_matrix(self.cov_main, jnp.asarray(X1), jnp.asarray(X2))
        )

    def predict(self, Xstar):
        """Posterior mean at Xstar; squeezed to 1-d for single-output y
        (matching the reference's column-at-a-time use)."""
        Ks = self.kernel(np.asarray(Xstar), self.X)
        mean = Ks @ self.alpha_r
        return mean[:, 0] if mean.shape[1] == 1 else mean

    def covariance(self, Xstar, include_obs: bool = False):
        """Posterior covariance at Xstar (+ observation noise if asked)."""
        Xstar = np.asarray(Xstar)
        Ks = self.kernel(Xstar, self.X)
        Kss = self.kernel(Xstar, Xstar)
        V = np.asarray(
            jsp_linalg.solve_triangular(
                jnp.asarray(self._L), jnp.asarray(Ks.T), lower=True
            )
        )
        cov = Kss - V.T @ V
        if include_obs:
            cov = cov + np.eye(len(Xstar)) * self.noise_var
        return cov

    def log_likelihood(self):
        n, dy = self.y.shape
        logdet = 2.0 * np.sum(np.log(np.diag(self._L)))
        quad = np.sum(self.y * self.alpha_r)
        return -0.5 * quad - 0.5 * dy * logdet - 0.5 * dy * n * np.log(2 * np.pi)

    def sample(self, Xstar, rng=None, n_samples=1):
        """Draw from the posterior at Xstar (utility beyond the reference)."""
        rng = rng or np.random.default_rng()
        mean = np.atleast_2d(self.predict(Xstar).T).T
        cov = self.covariance(Xstar)
        L = np.linalg.cholesky(cov + 1e-10 * np.eye(len(cov)))
        z = rng.standard_normal((len(cov), n_samples))
        return mean[:, :1] + L @ z


def mcov(X, cov: GPCov, noise_var):
    """Dense covariance incl. noise — treegp ``gp.mcov`` equivalent
    (reference ``synthetic.py:108``)."""
    return np.asarray(kernel_matrix(cov, jnp.asarray(np.asarray(X)), noise_var=noise_var))


def prior_sample(X, cov: GPCov, noise_var, rng=None, n_samples=1):
    """Sample from the GP prior at X (treegp ``gp.prior_sample`` analog)."""
    from gprf_tpu.linalg.jitchol import jitchol

    rng = rng or np.random.default_rng()
    K = mcov(X, cov, noise_var)
    L = jitchol(K)
    return L @ rng.standard_normal((len(K), n_samples))
