"""Vectorized host-side (NumPy) kernel evaluation.

The prediction/analysis paths loop over many small blocks; evaluating each
tiny kernel matrix on the device costs a round trip that dwarfs the
arithmetic.  These NumPy
mirrors of :mod:`gprf_tpu.kernels.covfn` keep data-prep/analysis-scale work
on host; the jit-compiled device path remains the source of truth for the
objective, and a parity test pins the two together.
"""

from __future__ import annotations

import numpy as np

from gprf_tpu.kernels.gpcov import GPCov

AVG_EARTH_RADIUS_KM = 6371.0
_SQRT3 = 1.7320508075688772


def _sq_euclidean_np(X1, X2, lscales):
    U = X1 / lscales
    V = X2 / lscales
    d = U[:, None, :] - V[None, :, :]
    return np.sum(d * d, axis=-1)


def _sq_lld_np(X1, X2, lscales):
    r1 = np.radians(X1[:, :2])
    r2 = np.radians(X2[:, :2])
    lon1, lat1 = r1[:, 0:1], r1[:, 1:2]
    lon2, lat2 = r2[None, :, 0], r2[None, :, 1]
    hav = (
        np.sin((lat1 - lat2) / 2.0) ** 2
        + np.cos(lat1) * np.cos(lat2) * np.sin((lon1 - lon2) / 2.0) ** 2
    )
    d_surf = 2.0 * np.arcsin(np.minimum(np.sqrt(np.maximum(hav, 0.0)), 1.0)) * AVG_EARTH_RADIUS_KM
    d_depth = X1[:, 2][:, None] - X2[:, 2][None, :]
    return (d_surf / lscales[0]) ** 2 + (d_depth / lscales[1]) ** 2


def scaled_sq_distance_np(dfn_str, X1, X2, dfn_params):
    if dfn_str == "euclidean":
        return _sq_euclidean_np(X1, X2, dfn_params)
    elif dfn_str == "lld":
        return _sq_lld_np(X1, X2, dfn_params)
    raise ValueError(dfn_str)


def cov_value_np(cov: GPCov, r2):
    sv = float(np.asarray(cov.wfn_params)[0])
    if cov.wfn_str == "se":
        return sv * np.exp(-r2)
    elif cov.wfn_str == "matern32":
        r = np.sqrt(np.maximum(r2, 0.0))
        return sv * (1.0 + _SQRT3 * r) * np.exp(-_SQRT3 * r)
    elif cov.wfn_str == "compact2":
        r = np.sqrt(np.maximum(r2, 0.0))
        base = np.maximum(1.0 - r, 0.0)
        return sv * base**4 * (4.0 * r + 1.0)
    raise ValueError(cov.wfn_str)


def cross_kernel_matrix_np(cov: GPCov, X1, X2) -> np.ndarray:
    X1 = np.asarray(X1, dtype=np.float64)
    X2 = np.asarray(X2, dtype=np.float64)
    dfn_params = np.asarray(cov.dfn_params, dtype=np.float64)
    return cov_value_np(cov, scaled_sq_distance_np(cov.dfn_str, X1, X2, dfn_params))


def kernel_matrix_np(cov: GPCov, X, noise_var=0.0) -> np.ndarray:
    K = cross_kernel_matrix_np(cov, X, X)
    if noise_var:
        K = K + noise_var * np.eye(len(K))
    return K
