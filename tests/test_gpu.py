"""Tests that need an NVIDIA card (marker ``gpu``); they skip without one.

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -q -m gpu
"""

import numpy as np
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("n,nblocks", [(1200, 9), (3000, 4)])
def test_schur_parity_on_the_card(gpu, n, nblocks):
    """f32 Schur objective and gradients on the card vs the f64 oracle on
    the card, and no reduced-precision gap beyond the CPU's."""
    import jax

    with jax.default_device(gpu):
        g = chip_smoke.wide_problem(n=n, nblocks=nblocks, dy=8)
        [(_, r)] = chip_smoke.correctness_phase([("gpu", g)])
    assert r["ok"], r["failures"]


def test_device_engine_step_on_the_card(gpu):
    """A few scan-L-BFGS steps of the fused flagship loss on the card."""
    import jax
    import jax.numpy as jnp

    from gprf_tpu.kernels.gpcov import GPCov
    from gprf_tpu.model.fused import FusedGridGPRF
    from gprf_tpu.optim.device_lbfgs import make_scan_lbfgs_runner
    from gprf_tpu.partition.grid import Blocker, grid_centers

    rng = np.random.default_rng(0)
    X = rng.uniform(size=(900, 2))
    b = Blocker(grid_centers(9))
    with jax.default_device(gpu):
        fused = FusedGridGPRF(X, rng.standard_normal((900, 8)),
                              b.block_centers, b.neighbors(), X, 0.01,
                              GPCov.create([1.0], [0.1, 0.1]), 0.01,
                              dtype=jnp.float32)
        init_fn, run_fn = make_scan_lbfgs_runner(fused.loss_fn(), num_steps=5)
        carry, (vals, _, _) = run_fn(init_fn(jnp.asarray(X.reshape(-1), jnp.float32)))
    vals = np.asarray(vals)
    assert carry["x"].devices() == {gpu}
    assert np.all(np.isfinite(vals)) and vals[-1] < vals[0]
