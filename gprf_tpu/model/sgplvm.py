"""Inducing-point GPLVM baselines, native in JAX.

The reference compares GPRF against GPy 0.6.0 baselines
(``do_gpy_gplvm``, ``gprfopt.py:232-319``): ``SparseGPLVM``,
``BayesianGPLVM`` (variational), and plain ``GPLVM`` (full GP).  GPy is not
part of this framework; instead the same baseline family is implemented
directly.

Estimator identification (round 4): despite the "FITC" label in the
paper's figures, GPy 0.6 ``SparseGPLVM`` performs **VarDTC** inference by
default (Titsias's collapsed variational bound) — so the reference-matched
estimator for its "sparse" rows is ``gplvm_type="titsias"`` below, which
reproduces the reference's sparse-baseline results point-for-point
(including the anomalous 500-inducing outlier at n=10k) where the FITC
marginal converges to higher-likelihood/worse-latent optima.  See the
FITC-suite section of docs/RESULTS.md for the measured comparison.

  * ``gplvm_type="sparse"``  — FITC collapsed marginal likelihood
    (Snelson & Ghahramani 2006) over ``num_inducing`` inducing inputs.
  * ``gplvm_type="bayesian"`` — the full Titsias & Lawrence (2010)
    variational GP-LVM: a factorized Gaussian posterior
    ``q(X) = prod_n N(x_n | mu_n, diag(s_n))`` with the collapsed bound
    evaluated through closed-form psi statistics of the SE kernel, minus
    ``KL(q(X) || p(X))`` against the observation prior
    ``N(X_obs, obs_std^2 I)`` — matching GPy ``BayesianGPLVM`` with
    ``X_variance = obs_std^2`` and the ``GPyConstDiagonalGaussian`` prior
    (reference ``gprfopt.py:247-250``, ``gpy_shims.py:11-85``).  Runs are
    scored on the latent means, like the reference.
  * ``gplvm_type="titsias"`` — Titsias (2009) collapsed bound with a point
    estimate for X (the round-1/2 approximation, kept as a cheaper
    baseline).
  * ``gplvm_type="basic"``   — exact full-GP marginal likelihood.

All bounds are computed with the numerically standard Cholesky/Woodbury
identities (never forming an n x n inverse for the sparse variants), jit
compiled, with gradients wrt X, Z, and log-lengthscale from autodiff.  The
driver :func:`do_sgplvm` replicates the reference's logging/checkpoint
protocol (``step_%05d_X.npy`` / ``step_%05d_IX.npy``, ``log.txt`` rows,
maxsec abort; ``gprfopt.py:269-318``).

Kernel convention note: the reference rescales GPy's RBF lengthscale by
sqrt(0.5) to match treegp (``gprfopt.py:239``); here both model and baseline
share one kernel definition, so no adjustment exists to make.
"""

from __future__ import annotations

import functools
import math
import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsp_linalg
import scipy.optimize

from gprf_tpu.kernels.covfn import cross_kernel_matrix
from gprf_tpu.kernels.gpcov import GPCov
from gprf_tpu.optim.driver import OutOfTimeError
from gprf_tpu.utils.io import save_step

_LOG_2PI = math.log(2.0 * math.pi)


def _rel_jitter(dtype):
    """Relative diagonal jitter for chol(Kmm).  1e-6 suffices in f64 but
    NaNs the f32 factorization at reference scales (m=2000 inducing points
    under an SE kernel is numerically low-rank): jitter 1e-6 gave a NaN
    f32 Cholesky, 1e-4 a clean one."""
    return 1e-6 if jnp.finfo(dtype).bits >= 64 else 1e-4


def _common_sparse_terms(X, Z, Y, cov: GPCov, noise_var):
    """Shared Woodbury pieces for FITC/Titsias.

    Returns (n, dy, Kdiag, Qdiag, A, g-independent stuff is built by
    callers).  A = Lm^-1 Kmn  with Kmm = k(Z,Z) + jitter.
    """
    n = X.shape[0]
    dy = Y.shape[1]
    Kmm = cross_kernel_matrix(cov, Z, Z)
    Kmm = Kmm + _rel_jitter(Kmm.dtype) * cov.signal_var * jnp.eye(
        Z.shape[0], dtype=Kmm.dtype
    )
    Knm = cross_kernel_matrix(cov, X, Z)
    Lm = jsp_linalg.cholesky(Kmm, lower=True)
    A = jsp_linalg.solve_triangular(Lm, Knm.T, lower=True)  # [m, n]
    Qdiag = jnp.sum(A * A, axis=0)  # diag of Knm Kmm^-1 Kmn
    Kdiag = jnp.full((n,), cov.signal_var)  # stationary: k(x,x) = sv
    return n, dy, Kdiag, Qdiag, A


def _woodbury_mll(A, g, Y, dy, n):
    """log N(Y | 0, A^T A + diag(g)) summed over Y columns via Woodbury."""
    m = A.shape[0]
    Ag = A / g[None, :]
    B = jnp.eye(m, dtype=A.dtype) + Ag @ A.T
    LB = jsp_linalg.cholesky(B, lower=True)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(LB))) + jnp.sum(jnp.log(g))
    Yg = Y / g[:, None]
    c = jsp_linalg.solve_triangular(LB, A @ Yg, lower=True)  # [m, dy]
    quad = jnp.sum(Y * Yg) - jnp.sum(c * c)
    return -0.5 * quad - 0.5 * dy * logdet - 0.5 * dy * n * _LOG_2PI


def fitc_mll(X, Z, Y, cov: GPCov, noise_var):
    """FITC collapsed marginal likelihood."""
    n, dy, Kdiag, Qdiag, A = _common_sparse_terms(X, Z, Y, cov, noise_var)
    g = Kdiag - Qdiag + noise_var
    return _woodbury_mll(A, g, Y, dy, n)


def titsias_bound(X, Z, Y, cov: GPCov, noise_var):
    """Titsias (2009) collapsed variational lower bound: DTC marginal
    likelihood minus the trace correction dy/(2 sigma^2) tr(Knn - Qnn)."""
    n, dy, Kdiag, Qdiag, A = _common_sparse_terms(X, Z, Y, cov, noise_var)
    g = jnp.full((n,), noise_var, dtype=A.dtype)
    mll = _woodbury_mll(A, g, Y, dy, n)
    trace_term = jnp.sum(Kdiag - Qdiag)
    return mll - 0.5 * dy * trace_term / noise_var


def psi_statistics(mu, S, Z, sv, ls, chunk: int = 0):
    """Closed-form psi statistics of the SE kernel ``sv exp(-sum_q
    (x_q - z_q)^2 / l_q^2)`` under ``q(x_n) = N(mu_n, diag(S_n))``
    (Titsias & Lawrence 2010; adapted to the treegp exponent convention —
    GPy's RBF lengthscale corresponds to ``l / sqrt(2)``).

    Returns (psi0 scalar, Psi1 [n, k], Psi2 [k, k]).  Psi2's per-point
    [k, k] matrices are summed in ``lax.map`` chunks with remat so peak
    memory stays at ``chunk * k^2`` (the z-bar coupling makes Psi2
    genuinely O(n k^2 d) — it does not factor into an einsum).
    """
    n, d = mu.shape
    k = Z.shape[0]
    l2 = ls**2  # [d]

    # Psi1[n, m] = sv prod_q (1 + 2 S/l^2)^{-1/2} exp(-(mu - z)^2/(l^2 + 2S))
    f1 = 1.0 + 2.0 * S / l2  # [n, d]
    e1 = (mu[:, None, :] - Z[None, :, :]) ** 2 / (l2 + 2.0 * S)[:, None, :]
    Psi1 = sv * jnp.exp(
        -0.5 * jnp.sum(jnp.log(f1), axis=1)[:, None] - jnp.sum(e1, axis=2)
    )

    # Psi2[m, m'] = sv^2 sum_n prod_q (1 + 4 S/l^2)^{-1/2}
    #     exp(-(z_m - z_m')^2/(2 l^2) - (mu - zbar)^2/(l^2/2 + 2 S))
    zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])  # [k, k, d]
    dz2 = (Z[:, None, :] - Z[None, :, :]) ** 2  # [k, k, d]
    base = -jnp.sum(dz2 / (2.0 * l2), axis=2)  # [k, k]
    if chunk <= 0:
        # bound the [chunk, k, k] temporaries near 2^24 elements (~64 MB)
        chunk = max(8, min(n, (1 << 24) // max(k * k, 1)))

    pad = (-n) % chunk
    mu_p = jnp.concatenate([mu, jnp.zeros((pad, d), mu.dtype)], axis=0)
    S_p = jnp.concatenate([S, jnp.ones((pad, d), S.dtype)], axis=0)
    w_p = jnp.concatenate(
        [jnp.ones((n,), mu.dtype), jnp.zeros((pad,), mu.dtype)]
    )
    nch = (n + pad) // chunk

    def body(args):
        mu_c, S_c, w_c = args  # [c, d], [c, d], [c]
        f2 = 1.0 + 4.0 * S_c / l2  # [c, d]
        logpref = -0.5 * jnp.sum(jnp.log(f2), axis=1)  # [c]
        denom = 0.5 * l2 + 2.0 * S_c  # [c, d]
        expo = jnp.zeros((mu_c.shape[0], k, k), mu.dtype)
        for q in range(d):  # d is tiny (2-3); accumulate without a d axis
            expo = expo + ((mu_c[:, q, None, None] - zbar[None, :, :, q]) ** 2
                           / denom[:, q, None, None])
        return jnp.sum(
            w_c[:, None, None] * jnp.exp(logpref[:, None, None] - expo),
            axis=0,
        )

    chunks = (
        mu_p.reshape(nch, chunk, d),
        S_p.reshape(nch, chunk, d),
        w_p.reshape(nch, chunk),
    )
    parts = jax.lax.map(jax.checkpoint(body), chunks)
    Psi2 = sv**2 * jnp.exp(base) * jnp.sum(parts, axis=0)
    psi0 = n * sv
    return psi0, Psi1, Psi2


def bgplvm_collapsed_F(mu, S, Z, Y, cov: GPCov, noise_var):
    """The collapsed expected-log-likelihood part of the Titsias & Lawrence
    (2010) variational GP-LVM bound (everything except the KL over X).

    Standard inducing-point algebra: with ``beta = 1/noise_var``,
    ``A = beta Lm^-1 Psi2 Lm^-T``, ``B = I + A``,

        F = dy [ -n/2 log 2pi + n/2 log beta - 1/2 logdet B
                 - beta/2 psi0 + 1/2 tr(A) ]
            - beta/2 ||Y||_F^2 + beta^2/2 ||LB^-1 Lm^-1 Psi1^T Y||_F^2

    At ``S -> 0`` this reduces exactly to :func:`titsias_bound` (psi0 ->
    tr(Knn), Psi1 -> Knm, Psi2 -> Knm^T Knm) — a tested identity.
    """
    n, dy = Y.shape
    kz = Z.shape[0]
    sv = cov.signal_var
    ls = jnp.asarray(cov.dfn_params)
    psi0, Psi1, Psi2 = psi_statistics(mu, S, Z, sv, ls)
    Kmm = cross_kernel_matrix(cov, Z, Z)
    Kmm = Kmm + _rel_jitter(Kmm.dtype) * sv * jnp.eye(kz, dtype=Kmm.dtype)
    Lm = jsp_linalg.cholesky(Kmm, lower=True)
    beta = 1.0 / noise_var
    T1 = jsp_linalg.solve_triangular(Lm, Psi2, lower=True)
    A = beta * jsp_linalg.solve_triangular(Lm, T1.T, lower=True).T
    B = jnp.eye(kz, dtype=A.dtype) + A
    LB = jsp_linalg.cholesky(B, lower=True)
    logdetB = 2.0 * jnp.sum(jnp.log(jnp.diagonal(LB)))
    P = jsp_linalg.solve_triangular(Lm, Psi1.T @ Y, lower=True)  # [k, dy]
    c = jsp_linalg.solve_triangular(LB, P, lower=True)
    F = dy * (
        -0.5 * n * _LOG_2PI
        + 0.5 * n * jnp.log(beta)
        - 0.5 * logdetB
        - 0.5 * beta * psi0
        + 0.5 * jnp.trace(A)
    ) - 0.5 * beta * jnp.sum(Y * Y) + 0.5 * beta**2 * jnp.sum(c * c)
    return F


def bgplvm_bound(mu, S, Z, Y, cov: GPCov, noise_var, prior_mean=0.0,
                 prior_var=1.0):
    """Full variational GP-LVM lower bound:
    :func:`bgplvm_collapsed_F` minus ``KL(q(X) || N(prior_mean, prior_var))``.

    GPy's BayesianGPLVM keeps its internal standard-normal prior
    p(X) = N(0, I) (the reference leaves ``m.X.mean.set_prior(p)``
    commented out, ``gprfopt.py:250``, and adds the observation prior on
    the q-means manually in its objective wrapper — the driver here does
    the same)."""
    F = bgplvm_collapsed_F(mu, S, Z, Y, cov, noise_var)
    kl = 0.5 * jnp.sum(
        (S + (mu - prior_mean) ** 2) / prior_var
        - 1.0
        + jnp.log(prior_var)
        - jnp.log(S)
    )
    return F - kl


def full_gplvm_mll(X, Y, cov: GPCov, noise_var):
    """Exact GP marginal likelihood (the 'basic' GPLVM objective)."""
    n = X.shape[0]
    dy = Y.shape[1]
    K = cross_kernel_matrix(cov, X, X) + noise_var * jnp.eye(n, dtype=X.dtype)
    L = jsp_linalg.cholesky(K, lower=True)
    alpha = jsp_linalg.cho_solve((L, True), Y)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    return -0.5 * jnp.sum(Y * alpha) - 0.5 * dy * logdet - 0.5 * dy * n * _LOG_2PI


@functools.partial(jax.jit, static_argnames=("gplvm_type", "learn_lscale"))
def _objective_and_grads(X, Z, log_lscale, Y, sv, noise_var, gplvm_type, learn_lscale):
    def f(X, Z, log_lscale):
        dx = X.shape[1]
        ls = jnp.exp(log_lscale) * jnp.ones((dx,), dtype=X.dtype)
        cov = GPCov(wfn_params=jnp.asarray([sv], dtype=X.dtype), dfn_params=ls)
        # HIGHEST precision: the Woodbury solves/products feed log(g) and
        # the quad form; a reduced-precision f32 product (TF32 on the GPU)
        # injects gradient noise at n=10k scales that stalls L-BFGS
        with jax.default_matmul_precision("highest"):
            if gplvm_type == "sparse":
                return fitc_mll(X, Z, Y, cov, noise_var)
            elif gplvm_type == "titsias":
                return titsias_bound(X, Z, Y, cov, noise_var)
            elif gplvm_type == "basic":
                return full_gplvm_mll(X, Y, cov, noise_var)
        raise ValueError(gplvm_type)

    ll, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(X, Z, log_lscale)
    gX, gZ, gl = grads
    if not learn_lscale:
        gl = jnp.zeros_like(gl)
    return ll, gX, gZ, gl


@functools.partial(jax.jit, static_argnames=("learn_lscale",))
def _bgplvm_objective_and_grads(mu, logS, Z, log_lscale, Y, sv, noise_var,
                                learn_lscale):
    def f(mu, logS, Z, log_lscale):
        dx = mu.shape[1]
        ls = jnp.exp(log_lscale) * jnp.ones((dx,), dtype=mu.dtype)
        cov = GPCov(wfn_params=jnp.asarray([sv], dtype=mu.dtype), dfn_params=ls)
        with jax.default_matmul_precision("highest"):
            return bgplvm_bound(
                mu, jnp.exp(logS), Z, Y, cov, noise_var,
                prior_mean=0.0, prior_var=1.0,
            )

    ll, grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3))(mu, logS, Z, log_lscale)
    gmu, glogS, gZ, gl = grads
    if not learn_lscale:
        gl = jnp.zeros_like(gl)
    return ll, gmu, glogS, gZ, gl


def do_sgplvm(d, X0, C0, sdata, method="l-bfgs-b", maxsec=3600, gplvm_type="sparse", num_inducing=100, max_iters=None):
    """Baseline GPLVM driver with the reference's file protocol
    (``do_gpy_gplvm``, ``gprfopt.py:232-319``).

    ``max_iters=None`` keeps the reference's scipy budget
    (``{"ftol": 1e-6, "maxiter": 200}``, ``gprfopt.py:307``).  The
    reference optimizes GPy's *transformed* parameter array, where 200
    L-BFGS-B iterations go much further than on this driver's raw
    packing — pass a larger budget for converged baselines (the
    per-iteration cost here is ~100x cheaper than GPy's)."""
    X0 = np.asarray(X0, dtype=np.float64)
    n, xd = X0.shape
    Y = jnp.asarray(sdata.SY)
    sv = 1.0
    noise_var = sdata.noise_var
    learn_lscale = C0 is not None
    log_lscale0 = math.log(float(np.asarray(sdata.cov.dfn_params)[0]) if C0 is None else float(np.asarray(C0).reshape(-1)[0]))

    if gplvm_type == "basic":
        num_inducing = 0
    if num_inducing > 0:
        rng = np.random.default_rng(0)
        Z0 = X0[rng.choice(n, size=min(num_inducing, n), replace=False)].copy()
    else:
        Z0 = np.zeros((0, xd))

    variational = gplvm_type == "bayesian"
    # q(X) variances initialized at the observation noise, exactly the
    # reference's ``X_variance = ones * obs_std**2`` (gprfopt.py:249)
    logS0 = (
        np.full(X0.shape, 2.0 * math.log(max(float(sdata.obs_std), 1e-8)))
        if variational
        else np.zeros((0, xd))
    )

    nmeans = X0.size
    n_ls = logS0.size
    n_ix = Z0.size

    def pack(X, logS, Z, log_l):
        return np.concatenate(
            [X.flatten(), logS.flatten(), Z.flatten(),
             [log_l] if learn_lscale else []]
        )

    def unpack(xx):
        X = xx[:nmeans].reshape(X0.shape)
        logS = xx[nmeans : nmeans + n_ls].reshape(logS0.shape)
        Z = xx[nmeans + n_ls : nmeans + n_ls + n_ix].reshape(Z0.shape)
        log_l = xx[-1] if learn_lscale else log_lscale0
        return X, logS, Z, log_l

    sstep = [0]
    best = [np.inf, None]  # best finite (nll, xx) seen by any evaluation
    f_log = open(os.path.join(d, "log.txt"), "w")
    t0 = time.time()

    def llgrad_wrapper(xx):
        X, logS, Z, log_l = unpack(xx)
        save_step(d, sstep[0], X=X)
        if n_ix:
            np.save(os.path.join(d, "step_%05d_IX.npy" % sstep[0]), Z)

        if variational:
            ll, gX, glogS, gZ, gl = _bgplvm_objective_and_grads(
                jnp.asarray(X), jnp.asarray(logS), jnp.asarray(Z),
                jnp.asarray(log_l), Y, sv, noise_var, learn_lscale,
            )
            grad_parts = [np.asarray(gX).flatten(), np.asarray(glogS).flatten(),
                          np.asarray(gZ).flatten()]
        else:
            ll, gX, gZ, gl = _objective_and_grads(
                jnp.asarray(X), jnp.asarray(Z), jnp.asarray(log_l), Y,
                sv, noise_var, gplvm_type, learn_lscale,
            )
            grad_parts = [np.asarray(gX).flatten(), np.asarray(gZ).flatten()]
        nll = -float(ll)
        grad = -np.concatenate(
            grad_parts + ([[float(gl)]] if learn_lscale else [])
        ).astype(np.float64)

        prior_ll, prior_grad = sdata.x_prior(xx[:nmeans])
        nll -= prior_ll
        grad[:nmeans] -= prior_grad

        f_log.write("%d %.2f %.2f\n" % (sstep[0], time.time() - t0, -nll))
        f_log.flush()
        if np.isfinite(nll) and nll < best[0]:
            best[0], best[1] = nll, np.array(xx, dtype=np.float64)
        sstep[0] += 1
        if time.time() - t0 > maxsec:
            raise OutOfTimeError
        return nll, grad

    # Reference budget (max_iters=None) keeps the literal scipy options of
    # gprfopt.py:307.  An explicit --max_iters asks for a *converged*
    # baseline: tighten ftol and, because f32 device gradients can abort
    # scipy's line search long before the budget (observed at the FITC-2000
    # n=20k row: ~200 evals of a 2000-iteration budget), restart L-BFGS-B
    # from the current point while budget remains — a restart clears the
    # stale curvature memory that caused the failed line search.
    ftol = 1e-6 if max_iters is None else 1e-10
    budget = max_iters or 200
    x_cur = pack(X0, logS0, Z0, log_lscale0)
    zero_progress = 0
    try:
        while budget > 0:
            res = scipy.optimize.minimize(
                llgrad_wrapper,
                x_cur,
                jac=True,
                method=method,
                options={"ftol": ftol, "maxiter": budget},
            )
            f_log.write(
                "scipy: nit=%d success=%s %s\n"
                % (res.nit, res.success, str(res.message))
            )
            f_log.flush()
            budget -= max(int(res.nit), 1)
            if (
                max_iters is None
                or res.success
                or not np.all(np.isfinite(res.x))
            ):
                break
            # A restart that immediately fails its first line search is
            # at a point where the f32 gradient is no longer a usable
            # descent direction; further restarts from the same x only
            # burn evals.  Allow a couple (the fresh curvature memory
            # sometimes recovers), then stop.
            zero_progress = zero_progress + 1 if res.nit == 0 else 0
            if zero_progress >= 3:
                f_log.write("scipy: stopping after 3 zero-progress restarts\n")
                break
            x_cur = res.x
    except OutOfTimeError:
        print("terminated optimization for time")

    # the last checkpoint on disk can be a diverged line-search probe
    # (llgrad_wrapper saves every evaluation point); re-save the best finite
    # iterate as the final step so the analyzed final row is never a probe
    if best[1] is not None:
        Xb, _, Zb, _ = unpack(best[1])
        save_step(d, sstep[0], X=Xb)
        if n_ix:
            np.save(os.path.join(d, "step_%05d_IX.npy" % sstep[0]), Zb)
        f_log.write("%d %.2f %.2f\n" % (sstep[0], time.time() - t0, -best[0]))
    f_log.write("optimization finished after %.fs\n" % (time.time() - t0))
    f_log.close()
    with open(os.path.join(d, "finished"), "w") as f:
        f.write("")
