"""The production f32 objective against the f64 joint-form oracle.

The device engines evaluate the GPRF objective in float32 through the
Schur-complement pair form (:func:`gprf_value_and_grad_schur`).  The plain
reference is the joint-form oracle (:func:`gprf_value_and_grad`: every pair
term a 2m-wide Cholesky), run in float64.  :func:`schur_parity` compares the
two — objective, gradient in X and gradient in the hyperparameters — on one
:class:`~gprf_tpu.model.gprf.GPRF` problem, on the default device and, for
contrast, with the same f32 computation on the host CPU: a default-device
gap far above the CPU's points at reduced-precision products (TF32 on the
GPU) somewhere in the f32 path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gprf_tpu.model.objective import (
    GPRFParams,
    gprf_value_and_grad,
    gprf_value_and_grad_schur,
)

# Tolerances of the f32 Schur form against the f64 oracle, relative to the
# oracle.  f32 carries ~6e-8 relative precision, and a Cholesky-based
# density loses up to a factor cond(K) of it in the solves; with the noise
# variance as jitter, cond(K) of a block reaches ~1e3-1e5 at the widths the
# engines run (m = 136 to ~900).  On the CPU the f32 gaps measure up to
# 4e-6 (objective) and 2e-4 (gradX) at m <= 192, and 2e-5 and 7e-4 at
# m = 832.
# * objective: the scalar tails accumulate in f64 under x64, so the error
#   is the per-block f32 roundoff; 1e-4 is 5x the widest measured gap.
# * gradients: relative norm error of the whole vector.  The pullback
#   re-solves with the factors, and the gradX scatter-add sums in an
#   unspecified order on the GPU; 1e-2 is ~15x the widest measured gap and
#   far below the O(1) error of a wrong term.  TF32 (~5e-4 relative per
#   product) in the Schur algebra would push the device's gradient error
#   well past the CPU's — the gap ratio below, not a looser bound, is what
#   catches it.
LL_RTOL = 1e-4
GRAD_RTOL = 1e-2
# the default device's f32 gap may exceed the CPU's by this factor plus an
# absolute floor (two libraries, two summation orders) before it counts as
# a precision leak
GAP_RATIO = 10.0
GAP_FLOOR = {"ll": 1e-6, "gradX": 1e-4, "gradcov": 1e-4}


def _params(gprf, dtype):
    return GPRFParams(
        X=jnp.asarray(gprf.X, dtype=dtype),
        wfn_params=jnp.asarray(gprf.cov.wfn_params, dtype=dtype),
        dfn_params=jnp.asarray(gprf.cov.dfn_params, dtype=dtype),
        noise_var=jnp.asarray(gprf.noise_var, dtype=dtype),
    )


def schur_value_and_grad(gprf, dtype=jnp.float32):
    """(ll, gradX, gradCov) of the production Schur form at ``dtype``, on
    the default device (host NumPy results)."""
    a = gprf.layout.device_arrays()
    out = gprf_value_and_grad_schur(
        _params(gprf, dtype),
        jnp.asarray(gprf.Y, dtype=dtype),
        a["assignment"], a["mask"], a["edges"],
        a["unary_weights"].astype(dtype), a["pair_weights"].astype(dtype),
        dfn_str=gprf.cov.dfn_str, wfn_str=gprf.cov.wfn_str,
        grad_X=True, grad_cov=True,
    )
    return tuple(np.asarray(v, dtype=np.float64) for v in jax.device_get(out))


def oracle_value_and_grad(gprf):
    """(ll, gradX, gradCov) of the joint-form oracle in float64 on the
    default device."""
    a = gprf.layout.device_arrays()
    out = gprf_value_and_grad(
        _params(gprf, jnp.float64),
        jnp.asarray(gprf.Y, dtype=jnp.float64),
        a["assignment"], a["mask"], a["pair_assignment"], a["pair_mask"],
        a["unary_weights"].astype(jnp.float64),
        a["pair_weights"].astype(jnp.float64),
        dfn_str=gprf.cov.dfn_str, wfn_str=gprf.cov.wfn_str,
        grad_X=True, grad_cov=True,
    )
    return tuple(np.asarray(v, dtype=np.float64) for v in jax.device_get(out))


def relative_errors(test, ref) -> dict:
    """Relative error of the objective and relative norm errors of the two
    gradients."""
    ll, gX, gC = test
    ll_r, gX_r, gC_r = ref
    return {
        "ll": abs(float(ll) - float(ll_r)) / abs(float(ll_r)),
        "gradX": float(np.linalg.norm(gX - gX_r) / np.linalg.norm(gX_r)),
        "gradcov": float(np.linalg.norm(gC - gC_r) / np.linalg.norm(gC_r)),
    }


def schur_parity(gprf, dtype=jnp.float32, cpu_contrast: bool = True) -> dict:
    """Compare the production Schur form at ``dtype`` with the f64 oracle.

    Returns {"m", "B", "E", "device": {ll, gradX, gradcov}, "cpu": {...}
    or None, "ok": bool, "failures": [...]}.  Enables x64 (the oracle and
    the production engines' scalar accumulation both need it)."""
    jax.config.update("jax_enable_x64", True)
    ref = oracle_value_and_grad(gprf)
    dev = relative_errors(schur_value_and_grad(gprf, dtype), ref)
    cpu = None
    if cpu_contrast:
        with jax.default_device(jax.devices("cpu")[0]):
            cpu = relative_errors(schur_value_and_grad(gprf, dtype), ref)
    failures = []
    limits = {"ll": LL_RTOL, "gradX": GRAD_RTOL, "gradcov": GRAD_RTOL}
    for key, lim in limits.items():
        if not dev[key] < lim:
            failures.append("%s rel err %.3e >= %.1e" % (key, dev[key], lim))
        if cpu is not None and not dev[key] <= GAP_RATIO * cpu[key] + GAP_FLOOR[key]:
            failures.append(
                "%s gap %.3e on the device vs %.3e on the CPU: a "
                "reduced-precision product in the f32 path" % (key, dev[key], cpu[key])
            )
    return {
        "m": int(gprf.layout.block_pad),
        "B": int(gprf.n_blocks),
        "E": int(gprf.layout.n_edges),
        "device": dev,
        "cpu": cpu,
        "ok": not failures,
        "failures": failures,
    }
