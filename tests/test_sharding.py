"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gprf_tpu.kernels.gpcov import GPCov
from gprf_tpu.model.gprf import GPRF
from gprf_tpu.model.objective import GPRFParams
from gprf_tpu.parallel.sharding import (
    make_mesh,
    shard_layout_arrays,
    sharded_gprf_value_and_grad,
)
from gprf_tpu.partition.grid import Blocker, grid_centers


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple (virtual) devices")
    return make_mesh()


def _problem(rng, n=60, nblocks=9):
    X = rng.uniform(size=(n, 2))
    Y = rng.normal(size=(n, 3))
    b = Blocker(grid_centers(nblocks))
    blocks = b.block_clusters(X)
    cov = GPCov.create([1.0], [0.25, 0.25])
    g = GPRF(X, Y, None, cov, 0.01, block_idxs=blocks, neighbors=b.neighbors())
    return g


def test_sharded_matches_single_device(rng, mesh):
    g = _problem(rng)
    ll_ref, gX_ref, gC_ref = g.llgrad(grad_X=True, grad_cov=True)
    arrays = shard_layout_arrays(g.layout, mesh)
    # batches padded to a multiple of the mesh size
    assert arrays["assignment"].shape[0] % mesh.devices.size == 0
    params = GPRFParams(
        X=jnp.asarray(g.X),
        wfn_params=jnp.asarray(g.cov.wfn_params),
        dfn_params=jnp.asarray(g.cov.dfn_params),
        noise_var=jnp.asarray(g.noise_var),
    )
    ll, gX, gC = sharded_gprf_value_and_grad(
        params, jnp.asarray(g.Y), arrays, mesh, grad_X=True, grad_cov=True
    )
    assert np.isclose(float(ll), ll_ref, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(gX), gX_ref, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(gC), gC_ref, rtol=1e-8)


def test_sharded_inputs_actually_sharded(rng, mesh):
    g = _problem(rng)
    arrays = shard_layout_arrays(g.layout, mesh)
    shard_sizes = {
        len(s.data) for s in arrays["assignment"].addressable_shards
    }
    assert len(shard_sizes) == 1  # even split
    assert arrays["assignment"].sharding.is_fully_replicated is False


def test_sharded_training_step(rng, mesh):
    """One full optimizer step (the dryrun_multichip path) on the mesh."""
    import optax

    g = _problem(rng)
    arrays = shard_layout_arrays(g.layout, mesh)
    params = GPRFParams(
        X=jnp.asarray(g.X),
        wfn_params=jnp.asarray(g.cov.wfn_params),
        dfn_params=jnp.asarray(g.cov.dfn_params),
        noise_var=jnp.asarray(g.noise_var),
    )
    opt = optax.adam(1e-3)

    from gprf_tpu.model.objective import gprf_ll

    def loss(X):
        p = params._replace(X=X)
        return -gprf_ll(
            p,
            jnp.asarray(g.Y),
            arrays["assignment"],
            arrays["mask"],
            arrays["pair_assignment"],
            arrays["pair_mask"],
            arrays["unary_weights"],
            arrays["pair_weights"],
        )

    @jax.jit
    def step(X, opt_state):
        l, grad = jax.value_and_grad(loss)(X)
        updates, opt_state = opt.update(grad, opt_state)
        return optax.apply_updates(X, updates), opt_state, l

    X = params.X
    opt_state = opt.init(X)
    X1, opt_state, l0 = step(X, opt_state)
    X2, opt_state, l1 = step(X1, opt_state)
    assert np.isfinite(float(l0)) and np.isfinite(float(l1))
    assert not np.allclose(np.asarray(X2), np.asarray(X))


# ---- sharded fused engine (the flagship path: fused Schur + scan-L-BFGS) ----


def _fused_problem(rng, mesh_arg, n=96, nblocks=9):
    from gprf_tpu.model.fused import FusedGridGPRF
    from gprf_tpu.partition.grid import grid_centers

    X_obs = rng.uniform(size=(n, 2))
    Y = rng.standard_normal((n, 4))
    centers = np.asarray(grid_centers(nblocks))
    b = Blocker(centers)
    cov = GPCov.create([1.0], [0.3, 0.3])
    return FusedGridGPRF(
        X_obs, Y, centers, b.neighbors(), X_obs, 0.02, cov, 0.01, mesh=mesh_arg
    ), X_obs


def test_sharded_fused_loss_matches_single_device(rng, mesh):
    """The fused Schur objective under the mesh equals the single-device
    value (padding is zero-weight => exact, not approximate)."""
    fused_m, X_obs = _fused_problem(rng, mesh)
    rng2 = np.random.default_rng(0)
    fused_1, _ = _fused_problem(rng2, None)
    x0 = jnp.asarray(X_obs.reshape(-1))
    l_m = float(jax.jit(fused_m.loss_fn())(x0))
    l_1 = float(jax.jit(fused_1.loss_fn())(x0))
    assert np.isfinite(l_m)
    np.testing.assert_allclose(l_m, l_1, rtol=1e-10)


def test_sharded_fused_grad_matches_single_device(rng, mesh):
    fused_m, X_obs = _fused_problem(rng, mesh)
    rng2 = np.random.default_rng(0)
    fused_1, _ = _fused_problem(rng2, None)
    x0 = jnp.asarray(X_obs.reshape(-1))
    g_m = np.asarray(jax.jit(jax.grad(fused_m.loss_fn()))(x0))
    g_1 = np.asarray(jax.jit(jax.grad(fused_1.loss_fn()))(x0))
    np.testing.assert_allclose(g_m, g_1, rtol=1e-8, atol=1e-10)


def test_sharded_scan_lbfgs_trajectory_matches(rng, mesh):
    """The full device optimizer loop (scan-L-BFGS over the sharded fused
    Schur loss) reproduces the single-device trajectory."""
    from gprf_tpu.optim.device_lbfgs import make_scan_lbfgs_runner

    fused_m, X_obs = _fused_problem(rng, mesh)
    rng2 = np.random.default_rng(0)
    fused_1, _ = _fused_problem(rng2, None)
    x0 = jnp.asarray(X_obs.reshape(-1))

    trajs = []
    finals = []
    for fused in (fused_m, fused_1):
        init_fn, run_fn = make_scan_lbfgs_runner(fused.loss_fn(), num_steps=6)
        carry = init_fn(x0)
        vals = []
        for _ in range(2):  # two dispatches: state round-trips between them
            carry, (v, ok, gn) = run_fn(carry)
            vals.append(np.asarray(v))
        trajs.append(np.concatenate(vals))
        finals.append(np.asarray(carry["x"]))
    np.testing.assert_allclose(trajs[0], trajs[1], rtol=1e-8)
    np.testing.assert_allclose(finals[0], finals[1], rtol=1e-7, atol=1e-9)
    assert trajs[0][-1] < trajs[0][0]  # actually optimizing


def test_sharded_fused_seismic_loss(rng, mesh):
    """The seismic fused engine (PD-tree replay + lld/matern32 Schur
    objective + priors) under the mesh equals single-device."""
    from gprf_tpu.data.seismic import COL_DEPTH, COL_LAT, COL_LON, make_synthetic_catalog
    from gprf_tpu.model.fused_seismic import FusedSeismicGPRF
    from gprf_tpu.partition.pdtree import PDTree, wrap_lon

    cat = make_synthetic_catalog(n=160, seed=3)
    X_true = cat[:, (COL_LON, COL_LAT, COL_DEPTH)]
    prior_std = 20.0 * np.array([0.01, 0.01, 1.0])
    X0 = X_true + rng.standard_normal(X_true.shape) * prior_std
    Y = rng.standard_normal((160, 6))
    cov = GPCov.create([1.0], [40.0, 40.0], "lld", "matern32")
    X2 = X0[:, :2].copy()
    X2[:, 0] = wrap_lon(X2[:, 0])
    tree = PDTree(X2, minsize=50)
    edges = [(1, 0), (2, 0), (2, 1)]
    C0 = np.array([0.1, 1.0, 40.0, 40.0])

    losses = []
    for mesh_arg in (mesh, None):
        fused = FusedSeismicGPRF(
            X0, Y, tree, edges, X0, prior_std, cov, 0.1,
            task="xcov", mesh=mesh_arg,
        )
        theta0 = jnp.asarray(fused.theta0(X0, C0), dtype=fused.dtype)
        losses.append(float(jax.jit(fused.loss_fn())(theta0)))
    assert np.isfinite(losses[0])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-8)


def test_sharded_multistart_matches_single_device(rng, mesh):
    """vmapped multi-start over the mesh-sharded fused loss: per-replica
    trajectories must match the unsharded loss."""
    import jax.numpy as jnp
    from gprf_tpu.kernels.gpcov import GPCov
    from gprf_tpu.model.fused import FusedGridGPRF
    from gprf_tpu.optim.device_lbfgs import make_multistart_runner
    from gprf_tpu.partition.grid import Blocker, grid_centers

    n = 160
    SX = rng.uniform(size=(n, 2))
    X_obs = SX + rng.standard_normal(SX.shape) * 0.05
    Y = rng.standard_normal((n, 4))
    b = Blocker(grid_centers(9))
    cov = GPCov.create([1.0], [0.3, 0.3])

    def build(mesh_arg):
        return FusedGridGPRF(
            X_obs, Y, b.block_centers, b.neighbors(), X_obs, 0.05, cov, 0.01,
            mesh=mesh_arg,
        )

    x0s = jnp.stack(
        [jnp.asarray(X_obs.flatten()), jnp.asarray((X_obs + 0.01).flatten())]
    )
    vals = {}
    for name, fused in [("sharded", build(mesh)), ("single", build(None))]:
        init_fn, run_fn = make_multistart_runner(fused.loss_fn(), num_steps=4)
        carry = init_fn(x0s)
        carry, (v, _, _) = run_fn(carry)
        vals[name] = np.asarray(v)
    np.testing.assert_allclose(vals["sharded"], vals["single"], rtol=1e-9)


def test_sharded_fused_loss_f32_path(rng, mesh):
    """The production f32 fused loss composes with the mesh sharding: the
    objective and gradient match the single-device program up to f32
    reassociation of the cross-device sums."""
    from gprf_tpu.model.fused import FusedGridGPRF
    from gprf_tpu.parallel.mesh_check import GRAD_RTOL, LOSS_RTOL

    n = 96
    X = rng.uniform(size=(n, 2))
    Y = rng.normal(size=(n, 4))
    centers = np.asarray(grid_centers(9))
    b = Blocker(centers)
    cov = GPCov.create([1.0], [0.25, 0.25])
    f_mesh, f_one = (
        FusedGridGPRF(X, Y, centers, b.neighbors(), X, 0.05, cov, 0.01,
                      mesh=mesh_arg, dtype=jnp.float32)
        for mesh_arg in (mesh, None)
    )
    x0 = jnp.asarray(f_mesh.theta0(), dtype=jnp.float32)
    v1, g1 = jax.jit(jax.value_and_grad(f_mesh.loss_fn()))(x0)
    v2, g2 = jax.jit(jax.value_and_grad(f_one.loss_fn()))(x0)
    assert g1.dtype == jnp.float32  # the scalar tails accumulate in f64
    assert abs(float(v1 - v2)) / abs(float(v2)) < LOSS_RTOL
    assert float(jnp.linalg.norm(g1 - g2) / jnp.linalg.norm(g2)) < GRAD_RTOL


@pytest.mark.parametrize("n_devices", [2, 4])
def test_mesh_checks_tiny(mesh, n_devices):
    """The sharded-against-single parity run (the four-card smoke path) on
    a sub-mesh of the virtual CPU devices."""
    from gprf_tpu.parallel.mesh_check import run_mesh_checks

    sub = make_mesh(jax.devices()[:n_devices])
    r = run_mesh_checks(sub, n=12 * n_devices, nblocks=2 * n_devices + 1,
                        dy=3, seismic_n=12 * n_devices, seismic_blocksize=8,
                        steps=3)
    assert r["n_blocks"] == len(grid_centers(2 * n_devices + 1))
    for key in ("loss_rel", "grad_rel", "multistart_rel", "seismic_loss_rel"):
        assert np.isfinite(r[key])
    assert "peak_bytes" not in r  # the CPU backend keeps no memory stats
