"""Fused single-dispatch evaluation must match the unfused path exactly."""

import numpy as np

from gprf_tpu.kernels.gpcov import GPCov
from gprf_tpu.model.fused import FusedGridGPRF
from gprf_tpu.model.gprf import GPRF
from gprf_tpu.partition.grid import Blocker, grid_centers


def _setup(rng, n=120, nblocks=9):
    X_obs = rng.uniform(size=(n, 2))
    Y = rng.normal(size=(n, 5))
    b = Blocker(grid_centers(nblocks))
    cov = GPCov.create([1.0], [0.15, 0.15])
    obs_std = 0.02
    gprf = GPRF(
        X_obs, Y, block_fn=lambda XX: b.block_clusters(XX), cov=cov,
        noise_var=0.01, block_idxs=b.block_clusters(X_obs),
        neighbors=b.neighbors(),
    )
    fused = FusedGridGPRF(
        X_obs, Y, b.block_centers, b.neighbors(), X_obs, obs_std, cov, 0.01
    )
    return gprf, fused, X_obs, obs_std


def test_fused_matches_unfused(rng):
    gprf, fused, X_obs, obs_std = _setup(rng)
    n = len(X_obs)
    for trial in range(3):
        x = (X_obs + rng.normal(size=X_obs.shape) * 0.01).flatten()
        nll_f, g_f = fused.value_and_grad(x)
        gprf.update_X(x.reshape(X_obs.shape))
        ll, gX, _ = gprf.llgrad(grad_X=True)
        r = (x - X_obs.flatten()) / obs_std
        prior = -0.5 * np.sum(r**2) - 0.5 * 2 * n * np.log(2 * np.pi * obs_std**2)
        nll_ref = -(ll + prior)
        g_ref = -(gX.flatten() - r / obs_std)
        assert np.isclose(nll_f, nll_ref, rtol=1e-8), (nll_f, nll_ref)
        np.testing.assert_allclose(g_f, g_ref, rtol=1e-6, atol=1e-8)


def test_fused_capacity_growth(rng):
    gprf, fused, X_obs, obs_std = _setup(rng)
    m0 = fused.m
    # squash all points toward one corner: blocks overflow, capacity grows
    x = (X_obs * 0.05).flatten()
    nll, g = fused.value_and_grad(x)
    assert np.isfinite(nll)
    assert fused.m > m0
    # and the result still matches the unfused path at the new capacity
    gprf.update_X(x.reshape(X_obs.shape))
    ll, gX, _ = gprf.llgrad(grad_X=True)
    r = (x - X_obs.flatten()) / obs_std
    n = len(X_obs)
    prior = -0.5 * np.sum(r**2) - 0.5 * 2 * n * np.log(2 * np.pi * obs_std**2)
    assert np.isclose(nll, -(ll + prior), rtol=1e-8)


def test_assemble_layout_matches_cumsum_formula(rng):
    """The searchsorted group starts must reproduce cumsum(counts)-counts
    exactly, including at B > 128 (where the cumsum lowering once hit a
    compiler memory limit — the reason for the searchsorted form) and
    with empty and overflowing blocks."""
    import jax.numpy as jnp

    from gprf_tpu.model.fused import assemble_layout

    for n, B, m in [(500, 9, 80), (4000, 900, 8), (300, 150, 4)]:
        blocks = jnp.asarray(rng.integers(0, B, size=n), dtype=jnp.int32)
        assignment, mask, overflow = assemble_layout(blocks, B, m)
        order = np.argsort(np.asarray(blocks), kind="stable")
        counts = np.bincount(np.asarray(blocks), minlength=B)
        starts = np.cumsum(counts) - counts
        exp = np.zeros((B, m), dtype=np.int32)
        for b in range(B):
            take = order[starts[b]:starts[b] + min(counts[b], m)]
            exp[b, :len(take)] = take
        np.testing.assert_array_equal(
            np.asarray(assignment) * np.asarray(mask),
            exp * (np.arange(m)[None, :] < np.minimum(counts, m)[:, None]),
        )
        np.testing.assert_array_equal(
            np.asarray(mask),
            np.arange(m)[None, :] < counts[:, None],
        )
        assert bool(overflow) == bool(counts.max() > m)
