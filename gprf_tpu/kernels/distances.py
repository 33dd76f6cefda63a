"""Pairwise scaled distances, differentiable and batched.

Replaces the treegp ``VectorTree.kernel_matrix(X1, X2, distances_only=True)``
distance evaluators ("euclidean" and "lld" ``dfn_str``s, reference
``gprf.py:109`` / ``run_seismic.py:299``) with pure-JAX batched tensor math:
the euclidean distance is broadcast arithmetic (or one matmul for wide
inputs), and the great-circle ("lld") distance is an elementwise haversine whose
pure-python spec is the reference ``run_seismic.py:19-63`` (``dist_deg`` /
``dist_km``) combined with depth as ``sqrt(d_surface^2 + d_depth^2)``
(``run_seismic.py:230-233``).

Gradient policy at coincident points: the reference zeroes the self-derivative
rows of kernel derivative matrices (``dKv[p] = 0``, ``gprf.py:354``).  Here the
same effect falls out of :func:`safe_sqrt`, whose custom JVP returns a zero
tangent at (numerically) zero radicand, so d r / d x -> 0 as x' -> x instead
of the undefined 1/r limit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

AVG_EARTH_RADIUS_KM = 6371.0  # matches reference run_seismic.py:51

_SAFE_EPS = 1e-20


@jax.custom_jvp
def safe_sqrt(x):
    """sqrt with a zero derivative at x == 0 (instead of inf/nan)."""
    return jnp.sqrt(jnp.maximum(x, 0.0))


@safe_sqrt.defjvp
def _safe_sqrt_jvp(primals, tangents):
    (x,) = primals
    (t,) = tangents
    y = safe_sqrt(x)
    safe = x > _SAFE_EPS
    dydx = jnp.where(safe, 0.5 / jnp.where(safe, y, 1.0), 0.0)
    return y, dydx * t


_QUADRATIC_EXPANSION_MIN_DIM = 16


def sq_euclidean(X1, X2, lscales):
    """Scaled squared euclidean distance matrix.

    r2[a, b] = sum_d ((X1[a, d] - X2[b, d]) / lscales[d])^2

    For the low-dimensional inputs this framework works with (dx <= 3), the
    broadcast-difference form is used: it is exact in f32 (no catastrophic
    cancellation) and involves no matmul, so no reduced-precision f32
    product (TF32 on the GPU) can corrupt the kernel matrix enough to break
    Cholesky positive-definiteness.  For wide inputs the quadratic expansion
    ``|u|^2 - 2 u.v + |v|^2`` with a matmul at HIGHEST precision is used
    instead.
    """
    U = X1 / lscales
    V = X2 / lscales
    if X1.shape[-1] < _QUADRATIC_EXPANSION_MIN_DIM:
        diff = U[:, None, :] - V[None, :, :]
        return jnp.sum(diff * diff, axis=-1)
    u2 = jnp.sum(U * U, axis=-1)
    v2 = jnp.sum(V * V, axis=-1)
    cross = jnp.dot(U, V.T, precision=jax.lax.Precision.HIGHEST)
    r2 = u2[:, None] - 2.0 * cross + v2[None, :]
    return jnp.maximum(r2, 0.0)


@jax.custom_jvp
def _central_angle(hav):
    """2 * asin(sqrt(hav)) with a guarded derivative.

    The derivative 1/sqrt(hav * (1 - hav)) is singular at coincident
    (hav = 0) and antipodal (hav = 1) points; both ends are clamped to a
    zero tangent, matching the reference convention of zeroing the
    self-derivative (``dKv[p] = 0``, ``gprf.py:354``).  A single custom_jvp
    also sidesteps an XLA:CPU fusion miscompile observed in the autodiff
    backward of arcsin-of-clip-of-sqrt, which produced NaNs in the final
    SIMD tail lanes of each fused row reduction.
    """
    return 2.0 * jnp.arcsin(jnp.sqrt(jnp.clip(hav, 0.0, 1.0)))


@_central_angle.defjvp
def _central_angle_jvp(primals, tangents):
    (h,) = primals
    (t,) = tangents
    y = _central_angle(h)
    tiny = jnp.finfo(jnp.result_type(h)).tiny
    safe = (h > tiny) & (h < 1.0 - 1e-7)
    denom = jnp.sqrt(jnp.where(safe, h * (1.0 - h), 1.0))
    dydh = jnp.where(safe, 1.0 / denom, 0.0)
    return y, dydh * t


def _haversine_km(lonlat1, lonlat2):
    """Great-circle surface distance matrix in km.

    Elementwise haversine over the outer product of two (lon, lat) degree
    arrays; numerically identical to the reference ``dist_km(dist_deg(...))``
    chain at ``run_seismic.py:19-63`` (2*asin(sqrt(hav)) in radians times the
    earth radius).
    """
    r1 = jnp.radians(lonlat1)  # [n1, 2]
    r2 = jnp.radians(lonlat2)  # [n2, 2]
    lon1, lat1 = r1[:, 0:1], r1[:, 1:2]
    lon2, lat2 = r2[None, :, 0], r2[None, :, 1]
    sin_dlat = jnp.sin((lat1 - lat2) / 2.0)
    sin_dlon = jnp.sin((lon1 - lon2) / 2.0)
    hav = sin_dlat**2 + jnp.cos(lat1) * jnp.cos(lat2) * sin_dlon**2
    return _central_angle(hav) * AVG_EARTH_RADIUS_KM


def sq_lld(X1, X2, lscales):
    """Scaled squared lon/lat/depth distance matrix.

    r2[a, b] = (d_km(X1[a], X2[b]) / l_h)^2 + ((depth_a - depth_b) / l_z)^2

    with ``lscales = [l_h, l_z]`` in km.  Columns of X are (lon_deg, lat_deg,
    depth_km) as in the reference seismic dataset (``run_seismic.py:295``).
    """
    d_surf = _haversine_km(X1[:, :2], X2[:, :2])
    d_depth = X1[:, 2][:, None] - X2[:, 2][None, :]
    return (d_surf / lscales[0]) ** 2 + (d_depth / lscales[1]) ** 2


def scaled_sq_distance(dfn_str: str, X1, X2, dfn_params):
    """Dispatch: scaled *squared* distance matrix for a dfn_str."""
    if dfn_str == "euclidean":
        return sq_euclidean(X1, X2, dfn_params)
    elif dfn_str == "lld":
        return sq_lld(X1, X2, dfn_params)
    raise ValueError(f"unknown distance function {dfn_str!r}")


def scaled_distance(dfn_str: str, X1, X2, dfn_params):
    """Scaled distance matrix (with safe gradient at zero)."""
    return safe_sqrt(scaled_sq_distance(dfn_str, X1, X2, dfn_params))
