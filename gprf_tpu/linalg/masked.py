"""Padding-safe Gaussian log-density via batched Cholesky.

The reference evaluates each block term with per-block LAPACK calls
(``pdinv``: dpotrf + dtrtri + dpotri at ``gpy_linalg.py:219-240``, then
``dpotrs`` for the solve, inside ``gaussian_llgrad`` at ``gprf.py:496-591``)
and assembles gradients from an explicit precision matrix.  Here the whole
block population lives in one padded ``[B, m, m]`` tensor: ragged blocks are
masked so padded rows/columns become an identity sub-block, which factors
trivially, contributes exactly zero to the log-determinant and quadratic
form, and passes zero gradient back to padded entries.  One
``jax.lax.linalg.cholesky`` over the batch replaces B separate dpotrf calls,
and no inverse is ever materialized — gradients flow by autodiff through the
factorization and triangular solves.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import jax.scipy.linalg as jsp_linalg

_LOG_2PI = math.log(2.0 * math.pi)


def pad_kernel_matrix(K, mask):
    """Mask a kernel matrix for padded entries.

    Rows/columns where ``mask == 0`` are zeroed and their diagonal set to 1,
    so the padded matrix stays symmetric positive definite and the padded
    subspace is an independent standard normal that cancels exactly in the
    log-density (log det contribution ``log 1 = 0``; quadratic form sees
    zeroed Y rows).
    """
    mask = mask.astype(K.dtype)
    m2 = mask[:, None] * mask[None, :]
    eye = jnp.eye(K.shape[-1], dtype=K.dtype)
    return K * m2 + eye * (1.0 - mask)


def masked_gaussian_ll(K, Y, mask):
    """Gaussian log-density of Y rows under N(0, K), restricted to the mask.

    Equivalent math to the reference ``gaussian_llgrad`` value path
    (``gprf.py:515-544``):

        ll = -1/2 sum(Y * K^-1 Y) - dy/2 logdet K - dy * n_active/2 log 2pi

    K must already include the noise-variance diagonal.  Y rows outside the
    mask are ignored.  Returns a scalar.
    """
    ll, _, _ = masked_gaussian_ll_cached(K, Y, mask)
    return ll


def masked_gaussian_ll_cached(K, Y, mask):
    """As :func:`masked_gaussian_ll` but also returns (L, alpha) with
    ``L L^T = pad(K)`` and ``alpha = pad(K)^-1 Y_masked`` for reuse in
    prediction."""
    dy = Y.shape[-1]
    maskf = mask.astype(K.dtype)
    Kp = pad_kernel_matrix(K, mask)
    L = jsp_linalg.cholesky(Kp, lower=True)
    Ym = Y * maskf[:, None]
    alpha = jsp_linalg.cho_solve((L, True), Ym)
    quad = jnp.sum(Ym * alpha)
    # Padded diagonal entries of L are exactly 1 -> log contributes 0.
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    n_active = jnp.sum(maskf)
    ll = -0.5 * quad - 0.5 * dy * logdet - 0.5 * dy * n_active * _LOG_2PI
    return ll, L, alpha
