"""Fully-fused single-dispatch GPRF evaluation.

The reference pays per-evaluation Python/C++ crossing costs per block
(``gprf.py:236-241``); the batched path in :mod:`gprf_tpu.model.objective`
already collapses that to one device program, but still splits one optimizer
evaluation into host re-blocking + device objective + result fetch — three
host<->device transitions, each of which costs a dispatch and a
synchronisation.  This module puts the *entire* evaluation in one jit:

    X  ->  [device] nearest-center re-block (argmin + stable argsort +
           scatter into the padded layout), gather, masked batched
           objective, Gaussian X-prior, autodiff gradient  ->  (nll, grad)

Re-blocking is differentiation-safe: block membership is piecewise constant
in X, so gradients flow only through the gathers (identical to the
reference's treatment, where ``update_X`` re-blocks and gradients are
computed for the fixed partition).

A capacity flag is returned: if any block outgrows the padded slot count m,
the extra points are dropped from the objective and ``overflow`` is True —
the host driver must rebuild with a larger m (this mirrors the static-shape
contract of the layout).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from gprf_tpu.kernels.gpcov import GPCov
from gprf_tpu.model.objective import GPRFParams, gprf_ll, gprf_ll_schur


def assemble_layout(blocks, B: int, m: int):
    """Padded [B, m] assignment + mask from per-point block labels [n].

    Shared on-device layout assembly for every fused re-blocking path
    (grid argmin, PD-tree traversal, RPC median replay): stable-sort the
    labels, scatter slot positions, mark validity.  Returns (assignment,
    mask, overflow); points beyond slot m are dropped and flagged.
    """
    n = blocks.shape[0]
    order = jnp.argsort(blocks, stable=True)
    counts = jnp.bincount(blocks, length=B)
    # group starts via binary search into the sorted labels: a fixed
    # log2(n) gather ladder that, for labels present in `blocks`, returns
    # exactly cumsum(counts)-counts (the cumsum form once hit a compiler
    # memory limit at B=900, n=80k on an earlier accelerator).
    starts = jnp.searchsorted(blocks[order], jnp.arange(B, dtype=blocks.dtype),
                              side="left")
    pos = jnp.arange(n) - starts[blocks[order]]
    assignment = (
        jnp.zeros((B, m), dtype=jnp.int32)
        .at[blocks[order], pos]
        .set(order.astype(jnp.int32), mode="drop")
    )
    mask = jax.lax.broadcasted_iota(jnp.int32, (B, m), 1) < counts[:, None]
    overflow = jnp.max(counts) > m
    return assignment, mask, overflow


def fused_grid_objective(
    params: GPRFParams,
    Y,
    centers,          # [B, dx]
    edges,            # [E, 2] int32
    unary_weights,    # [B]
    X_obs_flat,       # [n*dx] prior means
    obs_std,          # scalar
    m: int,
    dfn_str: str = "euclidean",
    wfn_str: str = "se",
    pair_mode: str = "schur",
    mesh=None,
):
    """(ll + prior, overflow): pure-jax fused objective with on-device
    nearest-center re-blocking — the complete per-step objective of the
    reference synthetic driver (``gprfopt.py:377-417``).

    ``mesh`` shards the block/edge batches of the Schur form over a 1-d
    device mesh (see :func:`gprf_tpu.model.objective.gprf_ll_schur`)."""
    n = params.X.shape[0]
    B = centers.shape[0]

    def assemble(X):
        # HIGHEST precision: a reduced-precision f32 product (TF32 on the
        # GPU) misassigns points whose two nearest centers are close
        scores = -2.0 * jnp.dot(
            X, centers.T, precision=jax.lax.Precision.HIGHEST
        ) + jnp.sum(centers * centers, axis=1)
        blocks = jnp.argmin(scores, axis=1)
        return assemble_layout(blocks, B, m)

    # membership is a function of X but piecewise constant: compute it
    # outside the differentiated graph
    assignment, mask, overflow = assemble(jax.lax.stop_gradient(params.X))
    pair_weights = jnp.ones((edges.shape[0],), dtype=params.X.dtype)

    if pair_mode == "schur":
        ll = gprf_ll_schur(
            params, Y, assignment, mask, edges, unary_weights, pair_weights,
            dfn_str=dfn_str, wfn_str=wfn_str, mesh=mesh,
        )
    else:
        pair_assignment = jnp.concatenate(
            [assignment[edges[:, 0]], assignment[edges[:, 1]]], axis=1
        )
        pair_mask = jnp.concatenate([mask[edges[:, 0]], mask[edges[:, 1]]], axis=1)
        ll = gprf_ll(
            params,
            Y,
            assignment,
            mask,
            pair_assignment,
            pair_mask,
            unary_weights,
            pair_weights,
            dfn_str=dfn_str,
            wfn_str=wfn_str,
        )
    r = (params.X.reshape(-1) - X_obs_flat) / obs_std
    n_flat = X_obs_flat.shape[0]
    prior = -0.5 * jnp.sum(r * r) - 0.5 * n_flat * jnp.log(2 * jnp.pi * obs_std**2)
    return ll + prior, overflow


@functools.partial(
    jax.jit,
    static_argnames=("m", "dfn_str", "wfn_str", "grad_cov", "pair_mode", "mesh"),
)
def fused_grid_value_and_grad(
    params: GPRFParams,
    Y,
    centers,
    edges,
    unary_weights,
    X_obs_flat,
    obs_std,
    m: int,
    dfn_str: str = "euclidean",
    wfn_str: str = "se",
    grad_cov: bool = False,
    pair_mode: str = "schur",
    mesh=None,
):
    """(nll, ngrad_flat, ngradCov, overflow): one-dispatch objective plus
    gradient evaluation."""

    def objective(p):
        ll, overflow = fused_grid_objective(
            p, Y, centers, edges, unary_weights, X_obs_flat, obs_std,
            m=m, dfn_str=dfn_str, wfn_str=wfn_str, pair_mode=pair_mode,
            mesh=mesh,
        )
        return ll, overflow

    (ll, overflow), g = jax.value_and_grad(objective, has_aux=True)(params)
    if grad_cov:
        gC = jnp.concatenate(
            [jnp.reshape(g.noise_var, (1,)), g.wfn_params, g.dfn_params]
        )
    else:
        gC = jnp.zeros(
            (1 + g.wfn_params.shape[0] + g.dfn_params.shape[0],), dtype=params.X.dtype
        )
    return -ll, -g.X.reshape(-1), gC, overflow


class FusedSyntheticGPRF:
    """Device-fused synthetic GPRF evaluation for tasks x / cov / xcov over
    grid or RPC partitions — the synthetic counterpart of
    :class:`~gprf_tpu.model.fused_seismic.FusedSeismicGPRF`, completing the
    reference CLI's task dispatch (``gprfopt.py:548-574``) on the device
    engine.

    theta layout (matching the reference optimization vector,
    ``gprfopt.py:357-370``): [X.flatten()] (tasks x/xcov) ++
    [log(C).flatten() * cov_scale] (tasks cov/xcov), with the reference's
    ``cov_scale = 5`` preconditioning (``gprfopt.py:365-367,408``) and
    ``full_cov`` expansion (1-param block = shared lengthscale with nv/sv
    fixed; 4-param block = [nv, sv, l1, l2], ``gprfopt.py:333-345``).
    Priors: the isotropic Gaussian X-prior around X_obs and the near-uniform
    N(-1, 10^2) log-scale cov prior (``gprfopt.py:324-331``).  For task=cov
    the locations are pinned at the given X0 (the reference pins them at the
    true SX, ``gprfopt.py:553-556``).
    """

    COV_SCALE = 5.0

    def __init__(self, X0, Y, edges, X_obs, obs_std, cov: GPCov, noise_var,
                 task: str = "x", C0=None, centers=None, rpc_tree=None,
                 m=None, dtype=None, mesh=None, pair_chunk: int | None = None):
        assert task in ("x", "cov", "xcov")
        assert (centers is None) != (rpc_tree is None), (
            "exactly one of centers / rpc_tree selects the partition"
        )
        self.task = task
        self.mesh = mesh
        self.pair_chunk = pair_chunk
        if dtype is None:
            dtype = jnp.result_type(float)
        self.dtype = dtype
        self.Y = jnp.asarray(Y, dtype=dtype)
        self.X0 = np.asarray(X0, dtype=np.float64)
        self.shape = self.X0.shape

        if centers is not None:
            self.kind = "grid"
            self.centers = jnp.asarray(np.asarray(centers), dtype=dtype)
            B = len(centers)
            self._rpc = None
        else:
            from gprf_tpu.partition.rpc_device import FlatRPCTree

            self.kind = "rpc"
            self._rpc = FlatRPCTree(rpc_tree, d=self.shape[1])
            self.rpc_arrays = self._rpc.device_arrays(dtype)
            B = self._rpc.n_blocks
            self.centers = None
        self.n_blocks = B

        edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
        self.edges = jnp.asarray(edges)
        counts = np.zeros(B, dtype=np.int64)
        for i, j in edges:
            counts[i] += 1
            counts[j] += 1
        self.unary_weights = jnp.asarray(1.0 - counts.astype(np.float64), dtype=dtype)
        self.pair_weights = jnp.ones((len(edges),), dtype=dtype)
        self.X_obs_flat = jnp.asarray(np.asarray(X_obs).reshape(-1), dtype=dtype)
        self.obs_std = float(obs_std)
        self.cov = cov
        self.noise_var = float(noise_var)
        self.C0 = None if C0 is None else np.asarray(C0, dtype=np.float64).reshape(1, -1)
        if task in ("cov", "xcov"):
            assert self.C0 is not None and self.C0.shape[1] in (1, 4)

        if m is None:
            sizes = np.bincount(
                np.asarray(self._assign_host(self.X0)), minlength=B
            )
            m = (int(sizes.max()) + 7) // 8 * 8
        self.m = m

    # ---- partition ---------------------------------------------------------

    def _assign_device(self, X):
        """Per-point block labels on device (piecewise constant in X)."""
        if self.kind == "grid":
            scores = -2.0 * jnp.dot(
                X, self.centers.T, precision=jax.lax.Precision.HIGHEST
            ) + jnp.sum(self.centers * self.centers, axis=1)
            return jnp.argmin(scores, axis=1)
        from gprf_tpu.partition.rpc_device import assign_blocks_rpc

        return assign_blocks_rpc(
            X, self.rpc_arrays, self._rpc.depth, self._rpc.n_nodes
        )

    def _assign_host(self, X):
        return jax.device_get(
            self._assign_device(jnp.asarray(X, dtype=self.dtype))
        )

    # ---- theta packing -----------------------------------------------------

    def theta0(self, X0=None, C0=None):
        parts = []
        if self.task in ("x", "xcov"):
            X0 = self.X0 if X0 is None else np.asarray(X0, dtype=np.float64)
            parts.append(X0.reshape(-1))
        if self.task in ("cov", "xcov"):
            C0 = self.C0 if C0 is None else np.asarray(C0, dtype=np.float64)
            parts.append(np.log(C0.reshape(-1)) * self.COV_SCALE)
        return np.concatenate(parts)

    @property
    def ncov(self) -> int:
        """Length of the packed-cov tail of theta (0 for task=x).  Lets the
        device-loop drivers fetch just ``theta[-ncov:]`` for the
        per-dispatch covs.txt row instead of the full parameter vector."""
        return 0 if self.task == "x" else int(np.asarray(self.C0).size)

    def unpack_host(self, theta):
        """(X, FC) on host from a flat theta (for checkpointing/analysis)."""
        theta = np.asarray(theta, dtype=np.float64)
        nflat = int(np.prod(self.shape))
        if self.task in ("x", "xcov"):
            X = theta[:nflat].reshape(self.shape).copy()
        else:
            X = None
        if self.task in ("cov", "xcov"):
            c = (theta[nflat:] if self.task == "xcov" else theta) / self.COV_SCALE
            C = np.exp(c).reshape(self.C0.shape)
            if C.shape[1] == 1:
                FC = np.array(
                    [[self.noise_var, 1.0, C[0, 0], C[0, 0]]], dtype=np.float64
                )
            else:
                FC = C
        else:
            FC = None
        return X, FC

    def check_capacity(self, theta) -> bool:
        X, _ = self.unpack_host(theta)
        if X is None:
            return True
        counts = np.bincount(self._assign_host(X), minlength=self.n_blocks)
        return int(counts.max()) <= self.m

    def check_capacity_batch(self, thetas) -> bool:
        """Capacity check over an [R, ...] replica stack in ONE device
        dispatch (the multi-start driver calls this every outer iteration,
        and a host round trip per replica would serialise R dispatches)."""
        Xs = [self.unpack_host(t)[0] for t in np.asarray(thetas)]
        if Xs[0] is None:
            return True
        stacked = jnp.asarray(np.stack(Xs), dtype=self.dtype)
        blocks = jax.vmap(self._assign_device)(stacked)  # [R, n]
        counts = jax.vmap(
            lambda b: jnp.bincount(b, length=self.n_blocks)
        )(blocks)
        return int(jax.device_get(jnp.max(counts))) <= self.m

    def grow_capacity(self):
        self.m += 16

    def overflow_fn(self):
        """theta -> bool: does any block outgrow the padded slot count m at
        this point?  Composable into the optimizer's device program (the
        scan runner's ``aux_fn``) so capacity checks cost no host round
        trip; matches :meth:`check_capacity` exactly."""
        assign = self._assign_device
        B, m = self.n_blocks, self.m
        nflat = int(np.prod(self.shape))
        shape = self.shape
        task = self.task
        X_fixed = jnp.asarray(self.X0, dtype=self.dtype)

        def f(theta):
            if task in ("x", "xcov"):
                X = theta[:nflat].reshape(shape)
            else:
                X = X_fixed
            blocks = assign(jax.lax.stop_gradient(X))
            counts = jnp.bincount(blocks, length=B)
            return jnp.max(counts) > m

        return f

    # ---- the fused loss ----------------------------------------------------

    def loss_fn(self):
        dtype = self.dtype
        Y, edges = self.Y, self.edges
        uw, pw = self.unary_weights, self.pair_weights
        X_obs_flat, obs_std = self.X_obs_flat, self.obs_std
        B, m = self.n_blocks, self.m
        task = self.task
        nflat = int(np.prod(self.shape))
        shape = self.shape
        base_cov = self.cov
        noise_var = self.noise_var
        ncov = None if self.C0 is None else self.C0.shape[1]
        X_fixed = jnp.asarray(self.X0, dtype=dtype)
        mesh = self.mesh
        pair_chunk = self.pair_chunk
        if pair_chunk is None and m > 512:
            # wide-m default: bound the pair pass at [chunk, m, m] with
            # remat.  A memory bound: unchunked, the [E, m, m] chain runs
            # out of device memory under multi-start vmap at the 80k shapes.
            pair_chunk = 64
        cov_scale = self.COV_SCALE
        assign = self._assign_device
        dfn_str, wfn_str = base_cov.dfn_str, base_cov.wfn_str

        def loss(theta):
            if task in ("x", "xcov"):
                X = theta[:nflat].reshape(shape)
            else:
                X = X_fixed
            if task in ("cov", "xcov"):
                c = (theta[nflat:] if task == "xcov" else theta) / cov_scale
                C = jnp.exp(c)
                if ncov == 1:
                    nv = jnp.asarray(noise_var, dtype=dtype)
                    sv = jnp.asarray(1.0, dtype=dtype)
                    ls = jnp.stack([C[0], C[0]])
                else:
                    nv, sv = C[0], C[1]
                    ls = C[2:]
            else:
                nv = jnp.asarray(noise_var, dtype=dtype)
                sv = jnp.asarray(base_cov.wfn_params, dtype=dtype)[0]
                ls = jnp.asarray(base_cov.dfn_params, dtype=dtype)

            blocks = assign(jax.lax.stop_gradient(X))
            assignment, mask, _ = assemble_layout(blocks, B, m)

            params = GPRFParams(
                X=X, wfn_params=sv.reshape(1), dfn_params=ls, noise_var=nv
            )
            ll = gprf_ll_schur(
                params, Y, assignment, mask, edges, uw, pw,
                dfn_str=dfn_str, wfn_str=wfn_str, pair_chunk=pair_chunk,
                mesh=mesh,
            )

            if task in ("x", "xcov"):
                r = (X.reshape(-1) - X_obs_flat) / obs_std
                ll = ll - 0.5 * jnp.sum(r * r) - 0.5 * nflat * jnp.log(
                    2 * jnp.pi * obs_std**2
                )
            if task in ("cov", "xcov"):
                # near-uniform N(-1, 10^2) prior on the log-scale cov params
                # (reference gprfopt.py:324-331)
                rc = (c + 1.0) / 10.0
                ll = ll - 0.5 * jnp.sum(rc * rc) - 0.5 * c.shape[0] * jnp.log(
                    2 * jnp.pi * 100.0
                )
            return -ll

        return loss


class FusedGridGPRF(FusedSyntheticGPRF):
    """Grid task=x specialization of :class:`FusedSyntheticGPRF` — the
    flagship-benchmark entry point, kept as a named class for its reference
    signature (X0, Y, centers, edges, ...) and for the scipy-driver bridge
    :meth:`value_and_grad` (one-dispatch objective+gradient with in-dispatch
    overflow detection, :func:`fused_grid_value_and_grad`).  All state,
    layout, and loss construction live in the base class — the two were
    once separate implementations tested equal at 1e-12
    (tests/test_fused_synthetic.py::test_fused_task_x_matches_fusedgrid).
    """

    def __init__(self, X0, Y, centers, edges, X_obs, obs_std, cov: GPCov,
                 noise_var, m=None, dtype=None, mesh=None):
        super().__init__(
            X0, Y, edges, X_obs, obs_std, cov, noise_var, task="x",
            centers=centers, m=m, dtype=dtype, mesh=mesh,
        )

    def _params(self, x_flat):
        dtype = self.dtype
        return GPRFParams(
            X=jnp.asarray(np.asarray(x_flat).reshape(self.shape), dtype=dtype),
            wfn_params=jnp.asarray(self.cov.wfn_params, dtype=dtype),
            dfn_params=jnp.asarray(self.cov.dfn_params, dtype=dtype),
            noise_var=jnp.asarray(self.noise_var, dtype=dtype),
        )

    def value_and_grad(self, x_flat):
        """(nll, ngrad) for the scipy driver; grows capacity on overflow."""
        params = self._params(x_flat)
        while True:
            nll, ngrad, _, overflow = jax.device_get(
                fused_grid_value_and_grad(
                    params,
                    self.Y,
                    self.centers,
                    self.edges,
                    self.unary_weights,
                    self.X_obs_flat,
                    self.obs_std,
                    m=self.m,
                    dfn_str=self.cov.dfn_str,
                    wfn_str=self.cov.wfn_str,
                    mesh=self.mesh,
                )
            )
            if not overflow:
                return float(nll), np.array(ngrad, dtype=np.float64)
            self.grow_capacity()  # recompiles at the new m
