"""Flagship benchmark: GPRF objective+gradient evaluation time on the GPU.

Reproduces the reference's flagship configuration — synthetic n=10k latent
points, 100 grid blocks, the 180 axis-neighbour edges, task=x — and times
the on-device L-BFGS loop, one objective+gradient evaluation per iteration.
The reference does one evaluation in 7.30 s on one CPU core (BASELINE.md,
row 1).  A machine without a GPU is an error: there is no CPU fallback.

Prints ONE JSON line:
  {"metric", "value", "unit", "vs_baseline", "gflops", "f32_peak_share",
   "platform", "device_kind", "device_count", "nvidia_smi"}

    python bench.py
"""

import json
import sys
import time

import numpy as np

BASELINE_SEC_PER_EVAL = 7.30  # reference CPU (BASELINE.md row 1)


def build_problem(n=10000, nblocks=100, yd=50, lscale=0.06, obs_std=0.02, seed=0):
    """(FusedGridGPRF, X_obs) for the flagship shape.  Y is iid noise: the
    objective's time does not depend on Y's distribution."""
    from gprf_tpu.kernels.gpcov import GPCov
    from gprf_tpu.model.fused import FusedGridGPRF
    from gprf_tpu.partition.grid import Blocker, grid_centers

    rng = np.random.default_rng(seed)
    SX = rng.uniform(size=(n, 2))
    X_obs = SX + rng.standard_normal(SX.shape) * obs_std
    Y = rng.standard_normal((n, yd))
    cov = GPCov.create([1.0], [lscale, lscale])
    b = Blocker(grid_centers(nblocks))
    # axis-only edges: the reference's diag_connections=True numerically
    # collapses to axis-only at this grid (self-distance roundoff poisons
    # its threshold: 180 edges), so its 7.30 s/eval timed the 180-edge
    # workload
    fused = FusedGridGPRF(
        X_obs, Y, b.block_centers, b.neighbors(diag_connections=False),
        X_obs, obs_std, cov, 0.01,
    )
    return fused, X_obs


def main():
    from gprf_tpu.utils.compile_cache import configure_compile_cache
    from gprf_tpu.utils.device import nvidia_smi_name_power, require_gpu

    info = require_gpu()
    configure_compile_cache()
    smi = nvidia_smi_name_power()

    import jax
    import jax.numpy as jnp

    from gprf_tpu.optim.device_lbfgs import make_scan_lbfgs_runner
    from gprf_tpu.utils.flops import model_flops_per_eval, peak_f32_flops

    fused, X_obs = build_problem()
    loss = fused.loss_fn()
    steps_per_dispatch = 25
    init_fn, run_fn = make_scan_lbfgs_runner(loss, num_steps=steps_per_dispatch)
    t0 = time.time()
    carry = init_fn(jnp.asarray(X_obs.reshape(-1), dtype=fused.dtype))
    carry, _ = run_fn(carry)  # compile + warm
    jax.block_until_ready(carry["v"])
    compile_sec = time.time() - t0

    v_first = float(carry["v"])
    nruns = 4
    t0 = time.time()
    for _ in range(nruns):
        carry, _ = run_fn(carry)
    jax.block_until_ready(carry["v"])
    wall = time.time() - t0
    sec_per_eval = wall / (nruns * steps_per_dispatch)
    assert float(carry["v"]) <= v_first, "optimization not progressing"

    flops = model_flops_per_eval(
        B=fused.n_blocks, m=fused.m, E=int(fused.edges.shape[0]),
        dy=int(fused.Y.shape[1]), dx=2,
    )
    rate = flops / sec_per_eval
    sys.stderr.write(
        "%s; compile+first dispatch %.1fs; %.3f ms/eval; obj %.1f -> %.1f\n"
        % (smi, compile_sec, sec_per_eval * 1e3, v_first, float(carry["v"]))
    )
    print(json.dumps({
        "metric": "gprf_obj_grad_eval_n10k_100blocks",
        "value": sec_per_eval * 1e3,
        "unit": "ms/eval",
        "vs_baseline": BASELINE_SEC_PER_EVAL / sec_per_eval,
        "gflops": rate / 1e9,
        "f32_peak_share": rate / peak_f32_flops(info["kind"]),
        "platform": info["platform"],
        "device_kind": info["kind"],
        "device_count": info["count"],
        "nvidia_smi": smi,
    }))


if __name__ == "__main__":
    main()
