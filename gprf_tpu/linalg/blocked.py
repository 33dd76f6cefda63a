"""Blocked (panel) Cholesky and triangular solve in pure JAX.

These right-looking panel versions keep every XLA primitive at panel width,
and the trailing updates become large matmuls.  They were written because
XLA's monolithic f64 kernels exceeded a scoped-memory limit of an earlier
accelerator at m ~ 1000; that reason does not hold on the GPU, and whether
the monolithic cuSOLVER f64 path beats them there is not yet measured.  The
objective uses them for f64 blocks wider than 512.  Static Python loops over
panels (shapes are static), batched over leading dims.

``blocked_cholesky`` carries a custom VJP (the standard Cholesky pullback
``dK = sym(L^-T phi(L^T dL) L^-1)`` evaluated with two transposed blocked
solves): raw autodiff through the panel recursion stores every trailing
update — ~m^3/panel floats, 24 GB at the full-GP m = 10000 — while the
pullback needs only L and O(m^2) temporaries.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _blocked_cholesky_impl(K, panel: int):
    m = K.shape[-1]
    if m <= panel:
        return jnp.linalg.cholesky(K)
    with jax.default_matmul_precision("highest"):
        A11 = K[..., :panel, :panel]
        A21 = K[..., panel:, :panel]
        A22 = K[..., panel:, panel:]
        L11 = jnp.linalg.cholesky(A11)
        # L21 = A21 L11^-T
        L21 = jax.lax.linalg.triangular_solve(
            L11, A21, left_side=False, lower=True, transpose_a=True
        )
        S = A22 - jnp.einsum("...ik,...jk->...ij", L21, L21)
        L22 = _blocked_cholesky_impl(S, panel)
        top = jnp.concatenate(
            [L11, jnp.zeros(K.shape[:-2] + (panel, m - panel), K.dtype)], axis=-1
        )
        bot = jnp.concatenate([L21, L22], axis=-1)
        return jnp.concatenate([top, bot], axis=-2)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def blocked_cholesky(K, panel: int = 256):
    """Lower Cholesky of SPD [..., m, m] via recursive 2x2 panel blocks.

    Built from slices and concatenations only — no scatter updates, whose
    autodiff transposes allocate whole-matrix scatter-adds at wide shapes.
    """
    return _blocked_cholesky_impl(K, panel)


def _blocked_cholesky_fwd(K, panel):
    L = _blocked_cholesky_impl(K, panel)
    return L, L


def _blocked_cholesky_bwd(panel, L, dL):
    """Standard Cholesky pullback, O(m^2) memory: with
    P = phi(L^T dL) (lower triangle, halved diagonal),
    dK = sym(L^-T sym(P) L^-1), computed by two L^T-solves.

    HIGHEST matmul precision is mandatory (custom_vjp rules trace outside
    the caller's precision context; see CLAUDE.md)."""
    m = L.shape[-1]
    with jax.default_matmul_precision("highest"):
        P = jnp.einsum("...ki,...kj->...ij", L, dL)
        tril = jnp.tril(jnp.ones((m, m), dtype=L.dtype))
        eye = jnp.eye(m, dtype=L.dtype)
        phi = P * tril - 0.5 * eye * P
        sym = 0.5 * (phi + jnp.swapaxes(phi, -1, -2))
        N = blocked_tri_solve_T(L, sym, panel)  # L^-T sym
        D = blocked_tri_solve_T(L, jnp.swapaxes(N, -1, -2), panel)
        dK = 0.5 * (D + jnp.swapaxes(D, -1, -2))
    return (dK,)


blocked_cholesky.defvjp(_blocked_cholesky_fwd, _blocked_cholesky_bwd)


def blocked_tri_solve(L, B, panel: int = 256):
    """Solve L X = B (L lower-triangular [..., m, m], B [..., m, k]) by
    forward panels."""
    m = L.shape[-1]
    if m <= panel:
        return jax.lax.linalg.triangular_solve(
            L, B, left_side=True, lower=True, transpose_a=False
        )
    parts = []
    with jax.default_matmul_precision("highest"):
        for s in range(0, m, panel):
            e = min(s + panel, m)
            rhs = B[..., s:e, :]
            if parts:
                X_done = jnp.concatenate(parts, axis=-2)
                rhs = rhs - jnp.einsum(
                    "...ij,...jk->...ik", L[..., s:e, :s], X_done
                )
            parts.append(
                jax.lax.linalg.triangular_solve(
                    L[..., s:e, s:e], rhs, left_side=True, lower=True,
                    transpose_a=False,
                )
            )
    return jnp.concatenate(parts, axis=-2)


def blocked_tri_solve_T(L, B, panel: int = 256):
    """Solve L^T X = B (L lower-triangular [..., m, m], B [..., m, k]) by
    backward panels: the last panel row of X is solved first, then each
    earlier panel subtracts the transposed sub-diagonal coupling."""
    m = L.shape[-1]
    if m <= panel:
        return jax.lax.linalg.triangular_solve(
            L, B, left_side=True, lower=True, transpose_a=True
        )
    starts = list(range(0, m, panel))
    parts = [None] * len(starts)
    with jax.default_matmul_precision("highest"):
        for pi in reversed(range(len(starts))):
            s = starts[pi]
            e = min(s + panel, m)
            rhs = B[..., s:e, :]
            if pi + 1 < len(starts):
                X_done = jnp.concatenate(parts[pi + 1 :], axis=-2)
                # coupling: (L[e:, s:e])^T X[e:]
                rhs = rhs - jnp.einsum(
                    "...ji,...jk->...ik", L[..., e:, s:e], X_done
                )
            parts[pi] = jax.lax.linalg.triangular_solve(
                L[..., s:e, s:e], rhs, left_side=True, lower=True,
                transpose_a=True,
            )
    return jnp.concatenate(parts, axis=-2)
