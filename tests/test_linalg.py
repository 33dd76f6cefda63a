"""Masked padded Gaussian density vs direct NumPy computation."""

import numpy as np
import jax
import jax.numpy as jnp

from gprf_tpu.linalg.jitchol import jitchol
from gprf_tpu.linalg.masked import masked_gaussian_ll, pad_kernel_matrix

from reference_impl import LOG_2PI


def _dense_ll(K, Y):
    n = K.shape[0]
    dy = Y.shape[1]
    Kinv = np.linalg.inv(K)
    _, logdet = np.linalg.slogdet(K)
    return -0.5 * np.sum(Y * (Kinv @ Y)) - 0.5 * dy * logdet - 0.5 * dy * n * LOG_2PI


def _rand_spd(rng, n):
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


def test_masked_ll_matches_dense(rng):
    n, pad, dy = 11, 16, 3
    K = _rand_spd(rng, pad)
    Y = rng.normal(size=(pad, dy))
    mask = np.zeros(pad, dtype=bool)
    mask[:n] = True
    # garbage in the padded region must not affect the result
    ll = float(masked_gaussian_ll(jnp.asarray(K), jnp.asarray(Y), jnp.asarray(mask)))
    expect = _dense_ll(K[:n, :n], Y[:n])
    assert np.isclose(ll, expect, rtol=1e-10)


def test_masked_ll_scattered_mask(rng):
    pad, dy = 12, 2
    K = _rand_spd(rng, pad)
    Y = rng.normal(size=(pad, dy))
    mask = np.array([True, False, True, True, False, True, False, True, True, False, True, False])
    idx = np.where(mask)[0]
    ll = float(masked_gaussian_ll(jnp.asarray(K), jnp.asarray(Y), jnp.asarray(mask)))
    expect = _dense_ll(K[np.ix_(idx, idx)], Y[idx])
    assert np.isclose(ll, expect, rtol=1e-10)


def test_pad_kernel_matrix_identity_block(rng):
    K = _rand_spd(rng, 6)
    mask = np.array([True, True, True, False, False, False])
    Kp = np.asarray(pad_kernel_matrix(jnp.asarray(K), jnp.asarray(mask)))
    np.testing.assert_allclose(Kp[3:, 3:], np.eye(3), atol=0)
    np.testing.assert_allclose(Kp[:3, 3:], 0.0, atol=0)
    np.testing.assert_allclose(Kp[:3, :3], K[:3, :3])


def test_jitchol_recovers_spd(rng):
    K = _rand_spd(rng, 8)
    L = jitchol(K)
    np.testing.assert_allclose(L @ L.T, K, rtol=1e-10)


def test_jitchol_adds_jitter_on_near_singular():
    # rank-deficient PSD matrix: plain cholesky fails, jitter rescues
    v = np.ones((5, 1))
    K = v @ v.T
    L = jitchol(K)
    assert np.all(np.isfinite(L))
    np.testing.assert_allclose(L @ L.T, K, atol=1e-3)


def test_blocked_cholesky_matches(rng):
    from gprf_tpu.linalg.blocked import blocked_cholesky

    for m, panel in [(70, 32), (64, 32), (100, 100), (130, 48)]:
        A = rng.normal(size=(3, m, m))
        K = np.einsum("bij,bkj->bik", A, A) + m * np.eye(m)
        L = np.asarray(blocked_cholesky(jnp.asarray(K), panel=panel))
        np.testing.assert_allclose(L, np.linalg.cholesky(K), rtol=1e-9, atol=1e-10)


def test_blocked_tri_solve_matches(rng):
    from gprf_tpu.linalg.blocked import blocked_cholesky, blocked_tri_solve

    m, k = 90, 17
    A = rng.normal(size=(2, m, m))
    K = np.einsum("bij,bkj->bik", A, A) + m * np.eye(m)
    L = np.linalg.cholesky(K)
    B = rng.normal(size=(2, m, k))
    X = np.asarray(blocked_tri_solve(jnp.asarray(L), jnp.asarray(B), panel=32))
    np.testing.assert_allclose(
        np.einsum("bij,bjk->bik", L, X), B, rtol=1e-9, atol=1e-10
    )


def test_blocked_tri_solve_T(rng):
    from gprf_tpu.linalg.blocked import blocked_tri_solve_T

    m, k = 70, 9
    A = rng.normal(size=(2, m, m))
    K = np.einsum("bij,bkj->bik", A, A) + m * np.eye(m)
    L = np.linalg.cholesky(K)
    B = rng.normal(size=(2, m, k))
    X = np.asarray(blocked_tri_solve_T(jnp.asarray(L), jnp.asarray(B), panel=16))
    np.testing.assert_allclose(
        np.einsum("bji,bjk->bik", L, X), B, rtol=1e-9, atol=1e-10
    )


def test_blocked_cholesky_custom_vjp_matches_autodiff(rng):
    """The O(m^2)-memory pullback must match autodiff through the native
    cholesky (symmetrized cotangents: K is consumed as a symmetric
    matrix)."""
    from gprf_tpu.linalg.blocked import blocked_cholesky

    m = 52
    A = rng.normal(size=(m, m))
    K = jnp.asarray(A @ A.T + m * np.eye(m))
    Cot = jnp.asarray(rng.normal(size=(m, m)))

    def f_blocked(K):
        return jnp.sum(blocked_cholesky(K[None], panel=16)[0] * Cot)

    def f_ref(K):
        return jnp.sum(jnp.linalg.cholesky(K) * Cot)

    g1 = np.asarray(jax.grad(f_blocked)(K))
    g2 = np.asarray(jax.grad(f_ref)(K))
    np.testing.assert_allclose(g1 + g1.T, g2 + g2.T, rtol=1e-8, atol=1e-10)

    # end-to-end through a symmetric K(X): gradients must agree exactly
    X = jnp.asarray(rng.uniform(size=(m, 2)))
    from gprf_tpu.kernels.covfn import cross_kernel_matrix
    from gprf_tpu.kernels.gpcov import GPCov

    cov = GPCov.create([1.0], [0.3, 0.3])

    def ll_b(X):
        Km = cross_kernel_matrix(cov, X, X) + 0.05 * jnp.eye(m)
        L = blocked_cholesky(Km[None], panel=16)[0]
        return jnp.sum(jnp.log(jnp.diagonal(L)))

    def ll_r(X):
        Km = cross_kernel_matrix(cov, X, X) + 0.05 * jnp.eye(m)
        return jnp.sum(jnp.log(jnp.diagonal(jnp.linalg.cholesky(Km))))

    gb = np.asarray(jax.grad(ll_b)(X))
    gr = np.asarray(jax.grad(ll_r)(X))
    np.testing.assert_allclose(gb, gr, rtol=1e-8, atol=1e-10)
