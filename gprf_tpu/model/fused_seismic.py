"""Fused single-program evaluation for the seismic workload.

The seismic analog of :mod:`gprf_tpu.model.fused`: one device program per
evaluation covering PD-tree re-blocking (device traversal of the frozen
split tree), gather, the Matern/great-circle GPRF objective, the location
and hyperparameter priors, and gradients — for tasks ``x``, ``cov``, and
``xcov`` (reference driver semantics at ``run_seismic.py:92-216``).

Reference transforms preserved: depth coordinate scaled by ``depth_scale``
(=100) in the optimization vector, covariance parameters optimized in log
space with ``sv`` pinned at 1 and the clamps nv <= 10, 1 <= lengthscales
<= 999, the seismic cov prior with its lengthscale explosion penalty, and
the longitude wrap for partitioning.  Deviation: the reference's ad-hoc
cov-gradient norm clipping (``run_seismic.py:175-177``) is an optimizer
heuristic for scipy L-BFGS-B and is not replicated in the on-device loop,
whose retrospective step control bounds steps already.
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp

from gprf_tpu.kernels.gpcov import GPCov
from gprf_tpu.model.fused import assemble_layout
from gprf_tpu.model.objective import GPRFParams, gprf_ll_schur
from gprf_tpu.partition.pdtree_device import FlatPDTree, assign_blocks_pdtree


class FusedSeismicGPRF:
    """Device-fused seismic GPRF evaluation over a frozen PD-tree.

    theta layout: [x_scaled.flatten()] (tasks x/xcov) ++ [log_c (4)]
    (tasks cov/xcov), matching the reference optimization vector.
    """

    def __init__(
        self,
        X0,
        Y,
        tree,  # host PDTree built on wrapped (lon, lat)
        edges,
        prior_means,
        prior_std,
        cov: GPCov,
        noise_var,
        task: str = "xcov",
        m: int | None = None,
        depth_scale: float = 100.0,
        pair_chunk: int | None = None,
        mesh=None,
        dtype=None,
    ):
        assert task in ("x", "cov", "xcov")
        self.task = task
        self.mesh = mesh
        if dtype is None:
            dtype = jnp.float32
        self.dtype = dtype
        self.Y = jnp.asarray(Y, dtype=self.dtype)
        self.flat = FlatPDTree(tree)
        self.tree_arrays = self.flat.device_arrays(self.dtype)
        self.depth = self.flat.depth
        B = self.flat.n_blocks
        edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
        self.edges = jnp.asarray(edges)
        counts = np.zeros(B, dtype=np.int64)
        for i, j in edges:
            counts[i] += 1
            counts[j] += 1
        self.unary_weights = jnp.asarray(1.0 - counts, dtype=self.dtype)
        self.pair_weights = jnp.ones((len(edges),), dtype=self.dtype)
        self.prior_means = jnp.asarray(prior_means, dtype=self.dtype)
        self.prior_std = jnp.asarray(prior_std, dtype=self.dtype)
        self.cov = cov
        self.noise_var = float(noise_var)
        self.depth_scale = float(depth_scale)
        self.shape = np.asarray(X0).shape
        self.pair_chunk = pair_chunk
        if m is None:
            sizes = [len(ix) for ix in tree.leaf_idx()]
            m = (max(sizes) + 7) // 8 * 8
        self.m = m
        self.n_blocks = B

    # ---- theta packing ----------------------------------------------------

    def theta0(self, X0, C0):
        parts = []
        if self.task in ("x", "xcov"):
            Xs = np.asarray(X0, dtype=np.float64).copy()
            Xs[:, 2] /= self.depth_scale
            parts.append(Xs.reshape(-1))
        if self.task in ("cov", "xcov"):
            c = np.log(np.asarray(C0, dtype=np.float64).reshape(-1))
            # the loss and ncov both assume the 4-slot seismic packing
            # (noise_var, sv, ls_horiz, ls_depth) — an --init_cov file of any
            # other length would silently mis-slice the theta tail
            if c.size != self.ncov:
                raise ValueError(
                    "seismic C0 must pack %d params, got %d" % (self.ncov, c.size)
                )
            parts.append(c)
        return np.concatenate(parts)

    @property
    def ncov(self) -> int:
        """Length of the packed-cov tail of theta (0 for task=x); the
        seismic cov packing is always (noise_var, sv, ls_horiz, ls_depth).
        See :meth:`gprf_tpu.model.fused.FusedSyntheticGPRF.ncov`."""
        return 0 if self.task == "x" else 4

    def unpack_host(self, theta):
        """(X, FC) on host from a flat theta (for checkpointing/analysis)."""
        theta = np.asarray(theta)
        n = int(np.prod(self.shape))
        if self.task in ("x", "xcov"):
            X = theta[:n].reshape(self.shape).copy()
            X[:, 2] *= self.depth_scale
        else:
            X = None
        if self.task in ("cov", "xcov"):
            c = theta[n:] if self.task == "xcov" else theta
            FC = np.exp(c).reshape(1, -1)
            FC[0, 1] = 1.0
            FC[0, 0] = min(FC[0, 0], 10.0)
            FC[0, 2:] = np.clip(FC[0, 2:], 1.0, 999.0)
        else:
            FC = None
        return X, FC

    def check_capacity(self, theta) -> bool:
        X, _ = self.unpack_host(theta)
        if X is None:
            return True
        from gprf_tpu.partition.pdtree import wrap_lon

        X2 = X[:, :2].copy()
        X2[:, 0] = wrap_lon(X2[:, 0])
        blocks = assign_blocks_pdtree(
            jnp.asarray(X2, dtype=self.dtype), self.tree_arrays, self.depth
        )
        counts = np.bincount(np.asarray(blocks), minlength=self.n_blocks)
        return int(counts.max()) <= self.m

    def check_capacity_batch(self, thetas) -> bool:
        """Capacity check over an [R, ...] replica stack in ONE device
        dispatch (vmapped PD-tree assignment)."""
        from gprf_tpu.partition.pdtree import wrap_lon

        X2s = []
        for t in np.asarray(thetas):
            X, _ = self.unpack_host(t)
            if X is None:
                return True
            X2 = X[:, :2].copy()
            X2[:, 0] = wrap_lon(X2[:, 0])
            X2s.append(X2)
        stacked = jnp.asarray(np.stack(X2s), dtype=self.dtype)
        counts = jax.vmap(
            lambda X2: jnp.bincount(
                assign_blocks_pdtree(X2, self.tree_arrays, self.depth),
                length=self.n_blocks,
            )
        )(stacked)
        return int(jax.device_get(jnp.max(counts))) <= self.m

    def grow_capacity(self):
        self.m += 16

    def overflow_fn(self):
        """theta -> bool overflow flag at this point (see
        :meth:`gprf_tpu.model.fused.FusedSyntheticGPRF.overflow_fn`)."""
        from gprf_tpu.partition.pdtree_device import assign_blocks_pdtree

        tree_arrays, depth = self.tree_arrays, self.depth
        B, m = self.n_blocks, self.m
        n = int(np.prod(self.shape))
        shape = self.shape
        task = self.task
        dtype = self.dtype
        depth_scale = self.depth_scale
        prior_means = self.prior_means

        def f(theta):
            if task in ("x", "xcov"):
                Xs = theta[:n].reshape(shape)
                X = Xs * jnp.asarray([1.0, 1.0, depth_scale], dtype=dtype)
            else:
                X = prior_means
            Xw = jax.lax.stop_gradient(X)
            lon_wrapped = (Xw[:, 0] + 22.0) % 360.0 - 22.0
            X2 = jnp.stack([lon_wrapped, Xw[:, 1]], axis=1)
            blocks = assign_blocks_pdtree(X2, tree_arrays, depth)
            counts = jnp.bincount(blocks, length=B)
            return jnp.max(counts) > m

        return f

    # ---- the fused loss ---------------------------------------------------

    def loss_fn(self):
        dtype = self.dtype
        Y = self.Y
        tree_arrays = self.tree_arrays
        depth = self.depth
        B = self.n_blocks
        m = self.m
        edges = self.edges
        uw = self.unary_weights
        pw = self.pair_weights
        prior_means = self.prior_means
        prior_std = self.prior_std
        depth_scale = self.depth_scale
        task = self.task
        pair_chunk = self.pair_chunk
        mesh = self.mesh
        base_cov = self.cov
        noise_var = self.noise_var
        n = int(np.prod(self.shape))
        shape = self.shape
        _LOG2PI = math.log(2.0 * math.pi)

        def loss(theta):
            if task in ("x", "xcov"):
                Xs = theta[:n].reshape(shape)
                X = Xs * jnp.asarray([1.0, 1.0, depth_scale], dtype=dtype)
            else:
                X = prior_means  # task=cov: locations fixed at the means
            if task in ("cov", "xcov"):
                c = theta[n:] if task == "xcov" else theta
                FC = jnp.exp(c)
                nv = jnp.minimum(FC[0], 10.0)
                sv = jnp.asarray(1.0, dtype=dtype)  # sv not learned
                ls = jnp.clip(FC[2:], 1.0, 999.0)
            else:
                nv = jnp.asarray(noise_var, dtype=dtype)
                sv = jnp.asarray(base_cov.wfn_params, dtype=dtype)[0]
                ls = jnp.asarray(base_cov.dfn_params, dtype=dtype)

            # device PD-tree re-block on wrapped (lon, lat); membership is
            # piecewise constant in X -> stop_gradient
            Xw = jax.lax.stop_gradient(X)
            lon_wrapped = (Xw[:, 0] + 22.0) % 360.0 - 22.0
            X2 = jnp.stack([lon_wrapped, Xw[:, 1]], axis=1)
            blocks = assign_blocks_pdtree(X2, tree_arrays, depth)
            assignment, mask, _ = assemble_layout(blocks, B, m)

            params = GPRFParams(
                X=X,
                wfn_params=sv.reshape(1),
                dfn_params=ls,
                noise_var=nv,
            )
            ll = gprf_ll_schur(
                params, Y, assignment, mask, edges, uw, pw,
                dfn_str="lld", wfn_str="matern32", pair_chunk=pair_chunk,
                mesh=mesh,
            )

            if task in ("x", "xcov"):
                r = (X - prior_means) / prior_std
                ll = ll - 0.5 * jnp.sum(r * r) - 0.5 * (n // 3) * (
                    3 * _LOG2PI + jnp.sum(jnp.log(prior_std**2))
                )
            if task in ("cov", "xcov"):
                # seismic cov prior + lengthscale explosion penalty
                cm = jnp.asarray([-2.3, 0.0, 3.6, 3.6], dtype=dtype)
                rc = (c - cm) / 1.5
                ll = ll - 0.5 * jnp.sum(rc * rc)
                ll = ll - jnp.where(
                    c[2] > 5.0, jnp.exp(70.0 * (c[2] - 5.0)), 0.0
                )
            return -ll

        return loss
