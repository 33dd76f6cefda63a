"""Time what XLA compiles for the GPRF objective's factorization stages.

At each deployment width it times, on the default device:
  * ``chol``: ``jnp.linalg.cholesky`` over the unary batch [B, m, m]
  * ``trsm``: ``lax.linalg.triangular_solve`` of the pair batch, [E, m, m]
    factors against [E, m, m] right-hand sides (the Schur B = L_i^-1 K_ij)
  * ``unary`` / ``full``: the production objective
    (:func:`gprf_tpu.model.objective.gprf_ll_schur`) without and with its
    edges, forward and forward+backward (gradient in X), in f32 at HIGHEST
    precision; ``full - unary`` is the pair Schur pass.

Widths: the flagship (10k points, 100 grid blocks, m ~ 136), the seismic
deployment (12k-event catalog, PD-tree blocks of 210, m ~ 192), a 9-block
slice of the 80k deployment (m ~ 900), and the full 80k / 100-block shape.
Y is iid: no stage's time depends on Y's law.  Prints one line per
measurement and the card's name and power limit.

    python scripts/xla_stage_times.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gprf_tpu.kernels.gpcov import GPCov  # noqa: E402
from gprf_tpu.model.gprf import GPRF  # noqa: E402
from gprf_tpu.model.objective import GPRFParams, gprf_ll_schur  # noqa: E402
from gprf_tpu.partition.grid import Blocker, grid_centers  # noqa: E402


def timeit(f, *args, reps=20):
    """Median wall ms of f(*args) after a warm-up, each call ending in
    block_until_ready."""
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def grid_problem(n, nblocks, extent, lscale, dy=50, seed=0):
    """Uniform points in grid blocks with the CLI's edges (axis and
    diagonal neighbours: 342 at 100 blocks)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2)) * extent
    b = Blocker(np.asarray(grid_centers(nblocks)) * extent)
    return GPRF(X, rng.standard_normal((n, dy)), None,
                GPCov.create([1.0], [lscale, lscale]), 0.01,
                block_idxs=b.block_clusters(X), neighbors=b.neighbors())


def seismic_problem(dy=50, seed=0):
    from gprf_tpu.data.seismic import (
        COL_DEPTH, COL_LAT, COL_LON, make_synthetic_catalog,
    )
    from gprf_tpu.partition.pdtree import pdtree_cluster

    cat = make_synthetic_catalog(n=12000, seed=seed)
    X = cat[:, (COL_LON, COL_LAT, COL_DEPTH)]
    blocks, _ = pdtree_cluster(X, blocksize=210)
    rng = np.random.default_rng(seed)
    return GPRF(X, rng.standard_normal((len(X), dy)), None,
                GPCov.create([1.0], [40.0, 40.0], "lld", "matern32"), 0.1,
                block_idxs=blocks, neighbor_threshold=0.6)


def stage_times(label, g):
    f32 = jnp.float32
    a = g.layout.device_arrays()
    p = GPRFParams(
        X=jnp.asarray(g.X, f32),
        wfn_params=jnp.asarray(g.cov.wfn_params, f32),
        dfn_params=jnp.asarray(g.cov.dfn_params, f32),
        noise_var=jnp.asarray(g.noise_var, f32),
    )
    Y = jnp.asarray(g.Y, f32)
    uw = a["unary_weights"].astype(f32)
    pw = a["pair_weights"].astype(f32)
    kw = dict(dfn_str=g.cov.dfn_str, wfn_str=g.cov.wfn_str)
    no_edges = jnp.zeros((0, 2), jnp.int32)
    B, m = a["assignment"].shape
    E = int(a["edges"].shape[0])

    def ll(p, edges, pw):
        return gprf_ll_schur(p, Y, a["assignment"], a["mask"], edges, uw, pw,
                             **kw)

    fwd = jax.jit(ll)
    grad = jax.jit(jax.grad(lambda p, e, w: ll(p, e, w).astype(f32)))

    # isolated XLA factorization ops at the same shapes
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    A = jax.random.normal(k1, (B, m, m), f32)
    K = jnp.einsum("bij,bkj->bik", A, A, precision="highest") / m + jnp.eye(m, dtype=f32)
    L = jnp.linalg.cholesky(K)
    Le = L[jnp.arange(E) % B]
    R = jax.random.normal(k2, (E, m, m), f32)
    chol = jax.jit(jnp.linalg.cholesky)
    trsm = jax.jit(lambda L, R: jax.lax.linalg.triangular_solve(
        L, R, left_side=True, lower=True))

    t = {
        "chol": timeit(chol, K),
        "trsm": timeit(trsm, Le, R),
        "unary_fwd": timeit(fwd, p, no_edges, pw[:0]),
        "full_fwd": timeit(fwd, p, a["edges"], pw),
        "unary_fwd_bwd": timeit(grad, p, no_edges, pw[:0]),
        "full_fwd_bwd": timeit(grad, p, a["edges"], pw),
    }
    t["pair_fwd"] = t["full_fwd"] - t["unary_fwd"]
    t["pair_fwd_bwd"] = t["full_fwd_bwd"] - t["unary_fwd_bwd"]
    print("%s B=%d E=%d m=%d dy=%d: %s" % (
        label, B, E, m, Y.shape[1],
        " ".join("%s=%.3fms" % kv for kv in t.items())), flush=True)


def main():
    from gprf_tpu.utils.compile_cache import configure_compile_cache
    from gprf_tpu.utils.device import nvidia_smi_name_power, require_gpu

    info = require_gpu()
    configure_compile_cache()
    jax.config.update("jax_enable_x64", True)  # as the device engine runs
    print("device:", info, flush=True)
    print(nvidia_smi_name_power(), flush=True)
    stage_times("flagship", grid_problem(10000, 100, 1.0, 0.06))
    stage_times("seismic", seismic_problem())
    stage_times("wide_slice_9", grid_problem(8000, 9, 0.3, 0.021213))
    stage_times("wide_80k_100", grid_problem(80000, 100, 1.0, 0.021213))


if __name__ == "__main__":
    main()
