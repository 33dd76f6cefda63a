"""Sharded-against-single-device parity of the production engines.

Runs the three things users shard over a 1-d mesh — the fused synthetic
xcov loss with a few scan-L-BFGS steps, replica multistart, and the
seismic fused engine — once with ``mesh=`` and once on one device, and
returns the relative differences.  The same function serves a tiny
virtual-CPU dry run and the full-size check on real cards.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# Tolerances.  The sharded and single-device programs run the same per-block
# arithmetic; they differ in the order of the cross-device reductions (the
# objective's block sums and the gradX scatter-add).  In f32 that
# reassociation moves a sum by a few ulps of its largest terms, i.e. ~1e-7
# relative, so 1e-5 leaves room without hiding a wrong block.  Optimizer
# trajectories amplify such differences step by step, so the trajectory
# bound is looser.
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
TRAJECTORY_RTOL = 1e-3


def check(cond, msg) -> None:
    """An explicit check: unlike ``assert`` it also holds under ``python -O``."""
    if not cond:
        raise AssertionError(msg)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1.0))


def run_mesh_checks(mesh, n: int, nblocks: int, dy: int, seismic_n: int,
                    seismic_blocksize: int, steps: int = 4, seed: int = 0):
    """Parity of the sharded engines against one device; returns a dict of
    relative errors and trajectories.  Raises AssertionError on a failed
    bound."""
    from gprf_tpu.data.seismic import (
        COL_DEPTH, COL_LAT, COL_LON, make_synthetic_catalog,
    )
    from gprf_tpu.kernels.gpcov import GPCov
    from gprf_tpu.model.fused import FusedSyntheticGPRF
    from gprf_tpu.model.fused_seismic import FusedSeismicGPRF
    from gprf_tpu.model.gprf import GPRF
    from gprf_tpu.optim.device_lbfgs import (
        make_multistart_runner, make_scan_lbfgs_runner,
    )
    from gprf_tpu.partition.grid import Blocker, grid_centers
    from gprf_tpu.partition.pdtree import PDTree, wrap_lon

    out = {}
    rng = np.random.default_rng(seed)
    X_obs = rng.uniform(size=(n, 2))
    Y = rng.standard_normal((n, dy))
    centers = np.asarray(grid_centers(nblocks))
    b = Blocker(centers)
    lscale = 0.6 / np.sqrt(n)  # the flagship's 0.06 at n = 10k
    cov = GPCov.create([1.0], [lscale, lscale])

    def build(mesh_arg):
        return FusedSyntheticGPRF(
            X_obs, Y, b.neighbors(), X_obs, lscale / 3.0, cov, 0.01,
            task="xcov", C0=np.array([[lscale]]), centers=centers,
            mesh=mesh_arg, dtype=jnp.float32,
        )

    fused, single = build(mesh), build(None)
    out["m"] = fused.m
    out["n_blocks"] = fused.n_blocks
    out["n_edges"] = int(fused.edges.shape[0])
    x0 = jnp.asarray(fused.theta0(), dtype=fused.dtype)
    v_m, g_m = jax.jit(jax.value_and_grad(fused.loss_fn()))(x0)
    v_1, g_1 = jax.jit(jax.value_and_grad(single.loss_fn()))(x0)
    check(np.isfinite(float(v_m)), f"non-finite sharded loss {v_m}")
    # what each card holds after the sharded step, before anything runs
    # on one card (the CPU backend keeps no such statistics)
    stats = [d.memory_stats() for d in mesh.devices.flat]
    if all(stats):
        out["peak_bytes"] = [int(st["peak_bytes_in_use"]) for st in stats]
    out["loss_rel"] = abs(float(v_m) - float(v_1)) / max(abs(float(v_1)), 1.0)
    out["grad_rel"] = _rel(g_m, g_1)
    check(out["loss_rel"] < LOSS_RTOL, out)
    check(out["grad_rel"] < GRAD_RTOL, out)

    # scan-L-BFGS over the sharded loss, one multi-step dispatch each
    trajs = {}
    for name, f in (("sharded", fused), ("single", single)):
        init_fn, run_fn = make_scan_lbfgs_runner(f.loss_fn(), num_steps=steps)
        carry, (vals, _, _) = run_fn(init_fn(x0))
        trajs[name] = np.asarray(vals)
        if name == "sharded":
            check(not np.allclose(np.asarray(carry["x"]), np.asarray(x0)), (
                "optimizer did not move the parameters"
            ))
    check(np.all(np.isfinite(trajs["sharded"])), trajs)
    check(trajs["sharded"][-1] <= trajs["sharded"][0], trajs)
    out["lbfgs_rel"] = float(np.max(
        np.abs(trajs["sharded"] - trajs["single"])
        / np.maximum(np.abs(trajs["single"]), 1.0)
    ))
    out["lbfgs_values"] = trajs["sharded"].tolist()
    check(out["lbfgs_rel"] < TRAJECTORY_RTOL, out)

    # replica-parallel multistart over the same mesh
    R = 4
    rng_ms = np.random.default_rng(seed + 1)
    theta0s = jnp.stack(
        [x0] + [
            x0 + jnp.asarray(rng_ms.standard_normal(x0.shape) * 0.01 * lscale,
                             dtype=x0.dtype)
            for _ in range(R - 1)
        ]
    )
    ms = {}
    for name, f in (("sharded", fused), ("single", single)):
        init_ms, run_ms = make_multistart_runner(f.loss_fn(), num_steps=steps)
        _, outs = run_ms(init_ms(theta0s))
        ms[name] = np.asarray(outs[0])  # [R, steps]
    check(np.all(np.isfinite(ms["sharded"])), ms)
    per_step = np.max(
        np.abs(ms["sharded"] - ms["single"])
        / np.maximum(np.abs(ms["single"]), 1.0),
        axis=0,
    )
    # step 0 is the loss at the R starting points: strict parity; later
    # steps compound optimizer-trajectory sensitivity
    out["multistart_rel"] = float(per_step[0])
    out["multistart_traj_rel"] = float(per_step[-1])
    check(out["multistart_rel"] < LOSS_RTOL, out)
    check(out["multistart_traj_rel"] < TRAJECTORY_RTOL, out)

    # seismic fused engine: lld/matern32 kernel, PD-tree re-block
    cat = make_synthetic_catalog(n=seismic_n, seed=3)
    means = cat[:, (COL_LON, COL_LAT, COL_DEPTH)]
    Ys = rng.standard_normal((len(means), dy))
    cov_s = GPCov.create([1.0], [40.0, 40.0], "lld", "matern32")
    prior_std = 20.0 * np.array([0.01, 0.01, 1.0])
    X2 = means[:, :2].copy()
    X2[:, 0] = wrap_lon(X2[:, 0])
    tree = PDTree(X2, minsize=seismic_blocksize)
    g0 = GPRF(
        means, Ys, None, cov_s, 0.1,
        block_idxs=tree.leaf_idx(), neighbor_threshold=0.6,
    )

    def build_seismic(mesh_arg):
        return FusedSeismicGPRF(
            means, Ys, tree, g0.neighbors, means, prior_std, cov_s, 0.1,
            task="xcov", mesh=mesh_arg,
        )

    fs, fs1 = build_seismic(mesh), build_seismic(None)
    out["seismic_m"] = fs.m
    out["seismic_n_blocks"] = fs.n_blocks
    out["seismic_n_edges"] = int(fs.edges.shape[0])
    th0 = jnp.asarray(
        fs.theta0(means, np.array([0.1, 1.0, 40.0, 40.0])), dtype=fs.dtype
    )
    vs_m, gs_m = jax.jit(jax.value_and_grad(fs.loss_fn()))(th0)
    vs_1, gs_1 = jax.jit(jax.value_and_grad(fs1.loss_fn()))(th0)
    check(np.isfinite(float(vs_m)), f"non-finite sharded seismic loss {vs_m}")
    out["seismic_loss_rel"] = (
        abs(float(vs_m) - float(vs_1)) / max(abs(float(vs_1)), 1.0)
    )
    out["seismic_grad_rel"] = _rel(gs_m, gs_1)
    check(out["seismic_loss_rel"] < LOSS_RTOL, out)
    check(out["seismic_grad_rel"] < GRAD_RTOL, out)
    init_s, run_s = make_scan_lbfgs_runner(fs.loss_fn(), num_steps=steps)
    _, (vals_s, _, _) = run_s(init_s(th0))
    vals_s = np.asarray(vals_s)
    check(np.all(np.isfinite(vals_s)), vals_s)
    check(vals_s[-1] <= vals_s[0], vals_s)
    out["seismic_lbfgs_values"] = vals_s.tolist()
    return out
