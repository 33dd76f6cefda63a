"""Parity tests of the GPRF objective/gradients vs the NumPy oracle, plus
the structural property tests from SURVEY.md §4."""

import numpy as np
import jax.numpy as jnp
import pytest

from gprf_tpu.kernels.gpcov import GPCov
from gprf_tpu.model.gprf import GPRF
from gprf_tpu.partition.grid import Blocker, grid_centers

from reference_impl import fd_grad, gaussian_llgrad_np, gprf_llgrad_np


def _problem(rng, n=40, dy=3, nblocks=4, lscale=0.25):
    X = rng.uniform(size=(n, 2))
    Y = rng.normal(size=(n, dy))
    b = Blocker(grid_centers(nblocks))
    block_idxs = b.block_clusters(X)
    cov = GPCov.create([1.0], [lscale, lscale])
    return X, Y, block_idxs, b, cov


def _mk_gprf(X, Y, block_idxs, cov, nv, neighbors):
    return GPRF(
        X,
        Y,
        block_fn=None,
        cov=cov,
        noise_var=nv,
        block_idxs=block_idxs,
        neighbors=neighbors,
    )


def test_single_term_parity(rng):
    """gaussian_llgrad vs the oracle at 1e-6 rtol (BASELINE.md north star)."""
    X = rng.uniform(size=(9, 2))
    Y = rng.normal(size=(9, 4))
    cov = GPCov.create([1.4], [0.3, 0.2])
    g = _mk_gprf(X, Y, [np.arange(9)], cov, 0.05, [])
    ll, gX, gC = g.gaussian_llgrad(X, Y, grad_X=True, grad_cov=True)
    ll_ref, gX_ref, gC_ref = gaussian_llgrad_np(X, Y, 1.4, np.array([0.3, 0.2]), 0.05)
    assert np.isclose(ll, ll_ref, rtol=1e-9)
    np.testing.assert_allclose(gX, gX_ref, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(gC, gC_ref, rtol=1e-7, atol=1e-9)


def test_gprf_combination_parity(rng):
    X, Y, block_idxs, b, cov = _problem(rng)
    neighbors = b.neighbors(diag_connections=True)
    g = _mk_gprf(X, Y, block_idxs, cov, 0.01, neighbors)
    ll, gX, gC = g.llgrad(grad_X=True, grad_cov=True)
    ll_ref, gX_ref, gC_ref = gprf_llgrad_np(
        X, Y, block_idxs, neighbors, 1.0, np.array([0.25, 0.25]), 0.01
    )
    assert np.isclose(ll, ll_ref, rtol=1e-9)
    np.testing.assert_allclose(gX, gX_ref, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(gC.reshape(-1), gC_ref, rtol=1e-6, atol=1e-8)


def test_single_block_equals_full_gp(rng):
    """Property: 1 block, no edges => exact full-GP log-likelihood."""
    X = rng.uniform(size=(25, 2))
    Y = rng.normal(size=(25, 2))
    cov = GPCov.create([1.0], [0.3, 0.3])
    g = _mk_gprf(X, Y, [np.arange(25)], cov, 0.02, [])
    ll, _, _ = g.llgrad()
    ll_ref, _, _ = gaussian_llgrad_np(X, Y, 1.0, np.array([0.3, 0.3]), 0.02)
    assert np.isclose(ll, ll_ref, rtol=1e-10)


def test_no_edges_equals_sum_of_local_gps(rng):
    """Property: empty edge set => sum of independent local GP terms."""
    X, Y, block_idxs, _, cov = _problem(rng)
    g = _mk_gprf(X, Y, block_idxs, cov, 0.01, [])
    ll, _, _ = g.llgrad()
    expect = sum(
        gaussian_llgrad_np(X[ix], Y[ix], 1.0, np.array([0.25, 0.25]), 0.01)[0]
        for ix in block_idxs
        if len(ix)
    )
    assert np.isclose(ll, expect, rtol=1e-10)


def test_local_false_is_all_pairs(rng):
    """Property: local=False => fully-connected pairwise objective
    (reference gprf.py:214-216)."""
    X, Y, block_idxs, _, cov = _problem(rng, n=30, nblocks=4)
    g = _mk_gprf(X, Y, block_idxs, cov, 0.01, [])
    ll, _, _ = g.llgrad(local=False)
    B = len(block_idxs)
    all_pairs = [(i, j) for i in range(B) for j in range(i)]
    ll_ref, _, _ = gprf_llgrad_np(
        X, Y, block_idxs, all_pairs, 1.0, np.array([0.25, 0.25]), 0.01
    )
    assert np.isclose(ll, ll_ref, rtol=1e-9)


def test_gradX_matches_finite_differences(rng):
    X, Y, block_idxs, b, cov = _problem(rng, n=24, nblocks=4)
    neighbors = b.neighbors()
    g = _mk_gprf(X, Y, block_idxs, cov, 0.01, neighbors)
    _, gX, _ = g.llgrad(grad_X=True)

    def f(Xflat):
        ll_ref, _, _ = gprf_llgrad_np(
            Xflat.reshape(X.shape), Y, block_idxs, neighbors, 1.0, np.array([0.25, 0.25]), 0.01
        )
        return ll_ref

    fd = fd_grad(f, X.copy().reshape(-1)).reshape(X.shape)
    np.testing.assert_allclose(gX, fd, rtol=2e-4, atol=1e-5)


def test_gradcov_matches_finite_differences_matern_lld(rng):
    """FD check on the seismic-style kernel where the oracle has no
    analytic gradients."""
    n = 15
    X = np.column_stack(
        [rng.uniform(120, 125, n), rng.uniform(-5, 5, n), rng.uniform(0, 100, n)]
    )
    Y = rng.normal(size=(n, 2))
    cov = GPCov.create([1.0], [40.0, 35.0], "lld", "matern32")
    block_idxs = [np.arange(0, 8), np.arange(8, n)]
    g = GPRF(X, Y, None, cov, 0.1, block_idxs=block_idxs, neighbors=[(1, 0)])
    ll, gX, gC = g.llgrad(grad_X=True, grad_cov=True)

    from reference_impl import kernel_np, LOG_2PI

    def term(Xa, Ya, sv, ls, nv):
        K = kernel_np(Xa, Xa, sv, ls, dfn="lld", wfn="matern32") + nv * np.eye(len(Xa))
        Kinv = np.linalg.inv(K)
        _, logdet = np.linalg.slogdet(K)
        dy = Ya.shape[1]
        return (
            -0.5 * np.sum(Ya * (Kinv @ Ya))
            - 0.5 * dy * logdet
            - 0.5 * dy * len(Xa) * LOG_2PI
        )

    def objective(theta):
        nv, sv, l1, l2 = theta
        ls = np.array([l1, l2])
        idx_pair = np.concatenate(block_idxs)
        ll = term(X[idx_pair], Y[idx_pair], sv, ls, nv)
        # each block has 1 neighbor => unary weight (1 - 1) = 0
        return ll

    theta0 = np.array([0.1, 1.0, 40.0, 35.0])
    assert np.isclose(ll, objective(theta0), rtol=1e-9)
    fd = fd_grad(objective, theta0, eps=1e-5)
    np.testing.assert_allclose(gC.reshape(-1), fd, rtol=2e-4, atol=1e-7)


def test_kernelized_matches_feature_objective(rng):
    """tr(K^-1 Y Y^T) = sum_k y_k^T K^-1 y_k: the kernelized objective on
    YY = Y Y^T must equal the feature-space objective."""
    X, Y, block_idxs, b, _ = _problem(rng, n=20, nblocks=4)
    cov = GPCov.create([1.0], [0.25, 0.25])
    neighbors = b.neighbors()
    g1 = _mk_gprf(X, Y, block_idxs, cov, 0.01, neighbors)
    ll1, gX1, _ = g1.llgrad(grad_X=True)
    YY = Y @ Y.T
    g2 = GPRF(
        X,
        YY,
        None,
        cov,
        0.01,
        kernelized=True,
        dy=Y.shape[1],
        block_idxs=block_idxs,
        neighbors=neighbors,
    )
    ll2, gX2, _ = g2.llgrad(grad_X=True)
    assert np.isclose(ll1, ll2, rtol=1e-9)
    np.testing.assert_allclose(gX1, gX2, rtol=1e-6, atol=1e-8)


def test_update_X_reblocks(rng):
    """update_X with a replayable block_fn regathers; objective changes
    consistently with a fresh model."""
    X, Y, block_idxs, b, cov = _problem(rng)
    g = GPRF(
        X,
        Y,
        block_fn=lambda XX: b.block_clusters(XX),
        cov=cov,
        noise_var=0.01,
        block_idxs=block_idxs,
        neighbors=b.neighbors(),
    )
    ll0 = g.llgrad()[0]
    X2 = X + rng.normal(size=X.shape) * 0.01
    g.update_X(X2)
    ll1 = g.llgrad()[0]
    fresh = GPRF(
        X2,
        Y,
        block_fn=None,
        cov=cov,
        noise_var=0.01,
        block_idxs=b.block_clusters(X2),
        neighbors=b.neighbors(),
    )
    assert np.isclose(ll1, fresh.llgrad()[0], rtol=1e-10)
    assert not np.isclose(ll0, ll1)


def test_compute_neighbors_matches_bruteforce(rng):
    X, Y, block_idxs, b, cov = _problem(rng, n=60, nblocks=9)
    g = _mk_gprf(X, Y, block_idxs, cov, 0.01, [])
    threshold = 0.1
    edges = set(g.compute_neighbors(threshold=threshold))
    # brute force: max k(Xi, Xj)/sv over entries
    from reference_impl import kernel_np

    expect = set()
    for i in range(len(block_idxs)):
        for j in range(i):
            if len(block_idxs[i]) == 0 or len(block_idxs[j]) == 0:
                continue
            Kij = kernel_np(X[block_idxs[i]], X[block_idxs[j]], 1.0, np.array([0.25, 0.25]))
            if np.max(np.abs(Kij)) > threshold:
                expect.add((i, j))
    assert edges == expect


@pytest.mark.parametrize("chunk", [None, 2])
def test_chunked_equals_unchunked(rng, chunk):
    X, Y, block_idxs, b, cov = _problem(rng)
    neighbors = b.neighbors()
    g = GPRF(
        X,
        Y,
        None,
        cov,
        0.01,
        block_idxs=block_idxs,
        neighbors=neighbors,
        unary_chunk=chunk,
        pair_chunk=chunk,
    )
    ll, gX, gC = g.llgrad(grad_X=True, grad_cov=True)
    g2 = _mk_gprf(X, Y, block_idxs, cov, 0.01, neighbors)
    ll2, gX2, gC2 = g2.llgrad(grad_X=True, grad_cov=True)
    assert np.isclose(ll, ll2, rtol=1e-12)
    np.testing.assert_allclose(gX, gX2, rtol=1e-10)
    np.testing.assert_allclose(gC, gC2, rtol=1e-10)


def test_schur_pair_form_matches_joint(rng):
    """The Schur-complement pair factorization must equal the joint 2m-wide
    form exactly (f64)."""
    import jax.numpy as jnp
    from gprf_tpu.model.objective import GPRFParams, gprf_ll, gprf_ll_schur

    X, Y, block_idxs, b, cov = _problem(rng)
    neighbors = b.neighbors()
    g = _mk_gprf(X, Y, block_idxs, cov, 0.01, neighbors)
    arrays = g.layout.device_arrays()
    params = GPRFParams(
        X=jnp.asarray(X),
        wfn_params=jnp.asarray(cov.wfn_params),
        dfn_params=jnp.asarray(cov.dfn_params),
        noise_var=jnp.asarray(0.01),
    )
    ll_joint = float(
        gprf_ll(
            params, jnp.asarray(Y), arrays["assignment"], arrays["mask"],
            arrays["pair_assignment"], arrays["pair_mask"],
            arrays["unary_weights"], arrays["pair_weights"],
        )
    )
    ll_schur = float(
        gprf_ll_schur(
            params, jnp.asarray(Y), arrays["assignment"], arrays["mask"],
            jnp.asarray(g.layout.edges), arrays["unary_weights"],
            arrays["pair_weights"],
        )
    )
    assert np.isclose(ll_schur, ll_joint, rtol=1e-12)

    # gradients too
    import jax

    def f_schur(p):
        return gprf_ll_schur(
            p, jnp.asarray(Y), arrays["assignment"], arrays["mask"],
            jnp.asarray(g.layout.edges), arrays["unary_weights"],
            arrays["pair_weights"],
        )

    def f_joint(p):
        return gprf_ll(
            p, jnp.asarray(Y), arrays["assignment"], arrays["mask"],
            arrays["pair_assignment"], arrays["pair_mask"],
            arrays["unary_weights"], arrays["pair_weights"],
        )

    gs = jax.grad(f_schur)(params)
    gj = jax.grad(f_joint)(params)
    np.testing.assert_allclose(np.asarray(gs.X), np.asarray(gj.X), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(gs.dfn_params), np.asarray(gj.dfn_params), rtol=1e-9
    )


def _parity_problem(m, kernel, seed=0, dy=3):
    """Three adjacent blocks of exactly m points in a chain (edges 1-0 and
    2-1), on the SE/euclidean kernel over the unit square or the
    Matern-3/2/great-circle kernel over (lon, lat, depth)."""
    rng = np.random.default_rng(seed)
    if kernel == "se":
        X = np.concatenate([
            rng.uniform(size=(m, 2)) * 0.3 + np.array([0.3 * i, 0.0])
            for i in range(3)
        ])
        cov = GPCov.create([1.0], [0.1, 0.1])
        nv = 0.01
    else:
        X = np.concatenate([
            np.column_stack([
                120.0 + 2.0 * i + 2.0 * rng.uniform(size=m),
                2.0 * rng.uniform(size=m),
                50.0 * rng.uniform(size=m),
            ])
            for i in range(3)
        ])
        cov = GPCov.create([1.0], [40.0, 40.0], "lld", "matern32")
        nv = 0.1
    Y = rng.normal(size=(3 * m, dy))
    blocks = [np.arange(i * m, (i + 1) * m) for i in range(3)]
    return GPRF(X, Y, None, cov, nv, block_idxs=blocks,
                neighbors=[(1, 0), (2, 1)])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kernel", ["se", "matern32_lld"])
@pytest.mark.parametrize("m", [8, 64, 136, 192])
def test_schur_matches_joint_oracle(m, kernel, dtype):
    """The production Schur form (objective, gradX, hyperparameter
    gradient) against the f64 joint-form oracle, at the flagship (136) and
    seismic (192) widths.  f32 is held to the tolerances stated in
    gprf_tpu.model.parity; f64 to roundoff."""
    from gprf_tpu.model import parity

    g = _parity_problem(m, kernel)
    assert g.layout.block_pad == m
    r = parity.schur_parity(g, dtype=jnp.dtype(dtype), cpu_contrast=False)
    if dtype == "float32":
        assert r["ok"], r["failures"]
    else:
        assert r["device"]["ll"] < 1e-11
        assert r["device"]["gradX"] < 1e-8
        assert r["device"]["gradcov"] < 1e-8


def test_schur_pair_chunking_matches(rng):
    import jax.numpy as jnp
    from gprf_tpu.model.objective import GPRFParams, gprf_ll_schur

    X, Y, block_idxs, b, cov = _problem(rng)
    neighbors = b.neighbors()
    g = _mk_gprf(X, Y, block_idxs, cov, 0.01, neighbors)
    arrays = g.layout.device_arrays()
    params = GPRFParams(
        X=jnp.asarray(X), wfn_params=jnp.asarray(cov.wfn_params),
        dfn_params=jnp.asarray(cov.dfn_params), noise_var=jnp.asarray(0.01),
    )
    args = (params, jnp.asarray(Y), arrays["assignment"], arrays["mask"],
            jnp.asarray(g.layout.edges), arrays["unary_weights"],
            arrays["pair_weights"])
    ll_full = float(gprf_ll_schur(*args))
    ll_chunked = float(gprf_ll_schur(*args, pair_chunk=3))
    assert np.isclose(ll_full, ll_chunked, rtol=1e-12)


def test_nonstationary_rejected(rng):
    X, Y, block_idxs, _, cov = _problem(rng, n=20)
    with pytest.raises(NotImplementedError):
        GPRF(X, Y, None, cov, 0.01, nonstationary=True, block_idxs=block_idxs, neighbors=[])
