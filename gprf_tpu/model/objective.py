"""The GPRF objective as one differentiable, jit-compiled function.

Implements the block-factored approximate log-likelihood of Moore & Russell
(2015), exactly the combination rule of the reference ``GPRF.llgrad``
(``gprf.py:206-296``):

    ll = sum_{(i,j) in E} log N(Y_ij | 0, K(X_ij))
         + sum_i (1 - |E_i|) log N(Y_i | 0, K(X_i))

where E is the block neighbor (edge) set and |E_i| the number of edges
touching block i.  Every unary/pair Gaussian term is a masked padded density
(:mod:`gprf_tpu.linalg.masked`) evaluated by a batched Cholesky; the two
batches (blocks ``[B, m, .]`` and stacked edge pairs ``[E, 2m, .]``) are each
one vmapped computation.  Gradients with respect to X, the kernel
hyperparameters, and the noise variance all come from ``jax.grad`` — the
gather of X into block slots transposes to exactly the scatter-add the
reference hand-codes at ``gprf.py:258-273``, and autodiff through the
Cholesky replaces the explicit ``pdinv`` precision matrices and per-row C++
derivative calls (``gprf.py:547-584``).

Edge chunking: for large edge sets the ``[E, 2m, 2m]`` kernel batch is
processed in ``lax.map`` chunks with rematerialization, bounding peak device
memory at ``chunk * (2m)^2`` while each chunk stays one batched computation.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gprf_tpu.kernels.covfn import cross_kernel_matrix
from gprf_tpu.kernels.gpcov import GPCov
from gprf_tpu.linalg.masked import masked_gaussian_ll

# Schur-form matmul precision, read once at import: the jit cache is not
# keyed on environment variables, so a mid-process change could mix
# compilations traced at two precisions.  "highest" keeps every f32 product
# in full f32 (on the GPU an f32 product may otherwise run in TF32); the
# distance computations keep their own HIGHEST regardless.
_SCHUR_PRECISION = os.environ.get("GPRF_SCHUR_PRECISION", "highest")


class GPRFParams(NamedTuple):
    """Differentiable parameters of the objective."""

    X: jnp.ndarray  # [n, dx] latent input locations
    wfn_params: jnp.ndarray  # [1] signal variance
    dfn_params: jnp.ndarray  # [k] lengthscales
    noise_var: jnp.ndarray  # [] observation noise variance


def _block_term(Xb, Yb, mask, cov: GPCov, noise_var):
    """Masked Gaussian log-density of one (possibly padded) block."""
    K = cross_kernel_matrix(cov, Xb, Xb)
    K = K + noise_var * jnp.eye(K.shape[-1], dtype=K.dtype)
    return masked_gaussian_ll(K, Yb, mask)


def _batch_terms(X, Y, assignment, mask, cov, noise_var, chunk_size):
    """Vector of masked block log-densities for a batch of gathers.

    assignment/mask: [Nb, m]; returns [Nb].
    """
    if assignment.shape[0] == 0:
        return jnp.zeros((0,), dtype=X.dtype)

    def one(args):
        idx, msk = args
        return _block_term(X[idx], Y[idx], msk, cov, noise_var)

    if chunk_size is None or assignment.shape[0] <= chunk_size:
        return jax.vmap(lambda idx, msk: one((idx, msk)))(assignment, mask)
    # lax.map with batch_size = chunked scan of vmapped chunks; remat the
    # chunk body so the backward pass recomputes kernels instead of storing
    # every [chunk, m, m] factorization.
    return jax.lax.map(jax.checkpoint(one), (assignment, mask), batch_size=chunk_size)


def _shard_batches(
    mesh, mesh_axis, assignment, mask, unary_weights, edges, pair_weights
):
    """Pad the unary [B, .] and edge [E, .] batches to multiples of the mesh
    size with zero-weight dummies (exact: weights are part of the objective)
    and pin them to a 1-d batch sharding — GSPMD then partitions the vmapped
    factorizations across devices and inserts the AllReduce for the scalar
    and the gradX scatter-add, the device equivalent of the reference's
    process-pool block fan-out (``gprf.py:218-229``)."""
    from jax.sharding import NamedSharding, PartitionSpec

    ndev = int(mesh.devices.size)
    shard_b = NamedSharding(mesh, PartitionSpec(mesh_axis))

    def pad0(a, target):
        extra = target - a.shape[0]
        if extra <= 0:
            return a
        return jnp.concatenate(
            [a, jnp.zeros((extra,) + a.shape[1:], dtype=a.dtype)], axis=0
        )

    B0 = assignment.shape[0]
    padB = -(-B0 // ndev) * ndev
    # padded blocks are fully masked: their padded kernel matrix is the
    # identity, so ll = 0 exactly, on top of the zero weight
    assignment = jax.lax.with_sharding_constraint(pad0(assignment, padB), shard_b)
    mask = jax.lax.with_sharding_constraint(pad0(mask, padB), shard_b)
    unary_weights = jax.lax.with_sharding_constraint(
        pad0(unary_weights, padB), shard_b
    )
    E0 = edges.shape[0]
    if E0 > 0:
        padE = -(-E0 // ndev) * ndev
        # dummy edges are (0, 0) with zero weight; the degenerate Schur
        # complement of block 0 against itself stays PD (noise variance)
        edges = jax.lax.with_sharding_constraint(pad0(edges, padE), shard_b)
        pair_weights = jax.lax.with_sharding_constraint(
            pad0(pair_weights, padE), shard_b
        )
    return assignment, mask, unary_weights, edges, pair_weights


def _schur_ll(
    X, Y, assignment, mask, edges, unary_weights, pair_weights, cov, noise_var,
    pair_chunk=None, mesh=None, mesh_axis="b",
):
    """GPRF objective with pair terms factored through the unary Cholesky.

    The joint pair covariance factors as

        chol([[Kii, Kij], [Kji, Kjj]]) = [[L_i, 0], [B^T, chol(S)]],
        B = L_i^-1 Kij,  S = Kjj - B^T B,

    so each edge needs one m-wide Cholesky (of the Schur complement S), one
    triangular solve, and one matmul instead of a 2m-wide Cholesky — 8x
    fewer factorization flops, and the L_i come free from the unary terms.
    Mathematically identical to the joint form (tested to f64 precision);
    autodiff flows through the shared factors.

    Matmuls run at HIGHEST precision: the Schur complement must stay
    numerically PSD, and a reduced-precision f32 product (TF32 on the GPU)
    is not accurate enough for that.
    """
    from gprf_tpu.linalg.masked import pad_kernel_matrix

    if mesh is not None:
        assignment, mask, unary_weights, edges, pair_weights = _shard_batches(
            mesh, mesh_axis, assignment, mask, unary_weights, edges, pair_weights
        )

    # f64 wide matrices go through panel-blocked primitives with a custom
    # VJP (linalg/blocked.py).  They were introduced for a scoped-memory
    # limit of an earlier accelerator that no longer applies; whether XLA's
    # monolithic f64 cholesky beats them on the GPU is still to be measured.
    # f32 at every width uses XLA's monolithic kernels, which are internally
    # blocked with O(m^2) memory (the panel recursion's nested-concat
    # assembly keeps every level live and runs out of memory at m ~ 10k).
    f64 = jnp.result_type(X.dtype) == jnp.float64
    if f64 and assignment.shape[1] > 512:
        from gprf_tpu.linalg.blocked import blocked_cholesky, blocked_tri_solve

        chol = blocked_cholesky
        tri_solve = blocked_tri_solve
    else:
        chol = jnp.linalg.cholesky

        def tri_solve(L, B):
            return jax.lax.linalg.triangular_solve(
                L, B, left_side=True, lower=True, transpose_a=False
            )

    _LOG2PI = math.log(2.0 * math.pi)
    dy = Y.shape[-1]
    m = assignment.shape[1]
    dtype = X.dtype
    eye = jnp.eye(m, dtype=dtype)
    # accumulate the cheap scalar tails (quad/logdet reductions, the
    # weighted block sums) in f64 when x64 is enabled: at large n the f32
    # ulp of the total (~0.25 at |v| ~ 3e6) exceeds real late-stage
    # improvements and floors convergence
    acc = jnp.float64 if jax.config.jax_enable_x64 else dtype

    with jax.default_matmul_precision(_SCHUR_PRECISION):
        # ---- unary pass: batched masked Cholesky + per-block ll pieces
        Xb = X[assignment]  # [B, m, dx]
        maskf = mask.astype(dtype)
        Kb = jax.vmap(lambda x: cross_kernel_matrix(cov, x, x))(Xb)
        Kb = Kb + noise_var * eye
        Kp = jax.vmap(pad_kernel_matrix)(Kb, mask)
        Ym = Y[assignment] * maskf[:, :, None]
        Ls = chol(Kp)
        Zs = tri_solve(Ls, Ym)
        quads = jnp.sum((Zs * Zs).astype(acc), axis=(1, 2))
        logdets = 2.0 * jnp.sum(
            jnp.log(jnp.diagonal(Ls, axis1=1, axis2=2)).astype(acc), axis=1
        )
        nbs = jnp.sum(maskf.astype(acc), axis=1)
        unary_ll = -0.5 * quads - 0.5 * dy * logdets - 0.5 * dy * nbs * _LOG2PI
        total = jnp.sum(unary_weights.astype(acc) * unary_ll)

        E = edges.shape[0]
        if E == 0:
            return total

        # ---- pair pass: Schur complement against the i-side factors
        def pair_batch(edges_c, pw_c):
            ei = edges_c[:, 0]
            ej = edges_c[:, 1]
            Kij = jax.vmap(lambda xi, xj: cross_kernel_matrix(cov, xi, xj))(
                Xb[ei], Xb[ej]
            )
            Kij = Kij * (maskf[ei][:, :, None] * maskf[ej][:, None, :])
            Bm = tri_solve(Ls[ei], Kij)
            # Schur complement: padded rows of Kp[ej] are identity and the
            # corresponding Bm columns are zero, so S stays padded-masked
            S = Kp[ej] - jnp.einsum("eki,ekj->eij", Bm, Bm)
            rhs = Ym[ej] - jnp.einsum("eki,ekd->eid", Bm, Zs[ei])
            nbj = jnp.sum(maskf[ej], axis=1)
            Lsc = chol(S)
            z2 = tri_solve(Lsc, rhs)
            quadp = quads[ei] + jnp.sum((z2 * z2).astype(acc), axis=(1, 2))
            logdetp = logdets[ei] + 2.0 * jnp.sum(
                jnp.log(jnp.diagonal(Lsc, axis1=1, axis2=2)).astype(acc), axis=1
            )
            nbp = nbs[ei] + nbj.astype(acc)
            pair_ll = -0.5 * quadp - 0.5 * dy * logdetp - 0.5 * dy * nbp * _LOG2PI
            return jnp.sum(pw_c.astype(acc) * pair_ll)

        if pair_chunk is None or E <= pair_chunk:
            return total + pair_batch(edges, pair_weights)
        # bound peak memory at [chunk, m, m]: pad the edge batch with
        # zero-weight dummy edges and scan remat'd chunks
        nch = (E + pair_chunk - 1) // pair_chunk
        padE = nch * pair_chunk
        edges_p = jnp.concatenate(
            [edges, jnp.zeros((padE - E, 2), dtype=edges.dtype)], axis=0
        ).reshape(nch, pair_chunk, 2)
        pw_p = jnp.concatenate(
            [pair_weights, jnp.zeros((padE - E,), dtype=pair_weights.dtype)]
        ).reshape(nch, pair_chunk)
        sums = jax.lax.map(
            jax.checkpoint(lambda args: pair_batch(*args)), (edges_p, pw_p)
        )
        return total + jnp.sum(sums)


@functools.partial(
    jax.jit,
    static_argnames=("dfn_str", "wfn_str", "unary_chunk", "pair_chunk"),
)
def gprf_ll(
    params: GPRFParams,
    Y,
    assignment,
    mask,
    pair_assignment,
    pair_mask,
    unary_weights,
    pair_weights,
    dfn_str: str = "euclidean",
    wfn_str: str = "se",
    unary_chunk: int | None = None,
    pair_chunk: int | None = None,
):
    """Scalar GPRF log-likelihood.

    Arguments are the layout tensors from
    :meth:`gprf_tpu.partition.layout.BlockLayout.device_arrays`.
    """
    cov = GPCov(
        wfn_params=params.wfn_params,
        dfn_params=params.dfn_params,
        dfn_str=dfn_str,
        wfn_str=wfn_str,
    )
    unary = _batch_terms(
        params.X, Y, assignment, mask, cov, params.noise_var, unary_chunk
    )
    ll = jnp.sum(unary_weights * unary)
    if pair_assignment.shape[0] > 0:
        pair = _batch_terms(
            params.X, Y, pair_assignment, pair_mask, cov, params.noise_var, pair_chunk
        )
        ll = ll + jnp.sum(pair_weights * pair)
    return ll


@functools.partial(
    jax.jit,
    static_argnames=("dfn_str", "wfn_str", "pair_chunk", "mesh", "mesh_axis"),
)
def gprf_ll_schur(
    params: GPRFParams,
    Y,
    assignment,
    mask,
    edges,
    unary_weights,
    pair_weights,
    dfn_str: str = "euclidean",
    wfn_str: str = "se",
    pair_chunk: int | None = None,
    mesh=None,
    mesh_axis: str = "b",
):
    """Scalar GPRF log-likelihood via the Schur-complement pair form
    (see :func:`_schur_ll`); numerically equal to :func:`gprf_ll`.

    ``mesh`` (a ``jax.sharding.Mesh``, hashable => jit-static) shards the
    unary and edge batches over the 1-d axis ``mesh_axis``; X/Y/params stay
    replicated and all collectives are compiler-inserted.
    """
    cov = GPCov(
        wfn_params=params.wfn_params,
        dfn_params=params.dfn_params,
        dfn_str=dfn_str,
        wfn_str=wfn_str,
    )
    return _schur_ll(
        params.X, Y, assignment, mask, edges, unary_weights, pair_weights,
        cov, params.noise_var, pair_chunk=pair_chunk, mesh=mesh,
        mesh_axis=mesh_axis,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "dfn_str", "wfn_str", "grad_X", "grad_cov", "pair_chunk", "mesh",
        "mesh_axis",
    ),
)
def gprf_value_and_grad_schur(
    params: GPRFParams,
    Y,
    assignment,
    mask,
    edges,
    unary_weights,
    pair_weights,
    dfn_str: str = "euclidean",
    wfn_str: str = "se",
    grad_X: bool = True,
    grad_cov: bool = False,
    pair_chunk: int | None = None,
    mesh=None,
    mesh_axis: str = "b",
):
    """(ll, gradX, gradCov) via the Schur-factored pair form — the fast
    default behind :meth:`gprf_tpu.model.gprf.GPRF.llgrad` (same contract
    as :func:`gprf_value_and_grad`, which remains the joint-form parity
    oracle)."""

    def f(p):
        return gprf_ll_schur(
            p, Y, assignment, mask, edges, unary_weights, pair_weights,
            dfn_str=dfn_str, wfn_str=wfn_str, pair_chunk=pair_chunk,
            mesh=mesh, mesh_axis=mesh_axis,
        )

    if not (grad_X or grad_cov):
        ll = f(params)
        g = jax.tree.map(jnp.zeros_like, params)
    else:
        ll, g = jax.value_and_grad(f)(params)

    gradX = g.X if grad_X else jnp.zeros_like(params.X)
    if grad_cov:
        gradCov = jnp.concatenate(
            [jnp.reshape(g.noise_var, (1,)), g.wfn_params, g.dfn_params]
        ).reshape(1, -1)
    else:
        ncov = 1 + params.wfn_params.shape[0] + params.dfn_params.shape[0]
        gradCov = jnp.zeros((1, ncov), dtype=params.X.dtype)
    return ll, gradX, gradCov


@functools.partial(
    jax.jit,
    static_argnames=("dfn_str", "wfn_str", "grad_X", "grad_cov", "unary_chunk", "pair_chunk"),
)
def gprf_value_and_grad(
    params: GPRFParams,
    Y,
    assignment,
    mask,
    pair_assignment,
    pair_mask,
    unary_weights,
    pair_weights,
    dfn_str: str = "euclidean",
    wfn_str: str = "se",
    grad_X: bool = True,
    grad_cov: bool = False,
    unary_chunk: int | None = None,
    pair_chunk: int | None = None,
):
    """(ll, gradX [n,dx], gradCov [1, 2+k]) — the reference ``llgrad`` tuple.

    gradCov layout matches the reference ``dKdi`` parameter order
    (``gprf.py:362-375``): [d/d noise_var, d/d signal_var, d/d lengthscales].
    When a gradient is not requested the corresponding output is zeros (the
    reference returns empty arrays; fixed shapes are jit-friendlier).
    """

    def f(p):
        return gprf_ll(
            p,
            Y,
            assignment,
            mask,
            pair_assignment,
            pair_mask,
            unary_weights,
            pair_weights,
            dfn_str=dfn_str,
            wfn_str=wfn_str,
            unary_chunk=unary_chunk,
            pair_chunk=pair_chunk,
        )

    if not (grad_X or grad_cov):
        ll = f(params)
        g = jax.tree.map(jnp.zeros_like, params)
    else:
        ll, g = jax.value_and_grad(f)(params)

    gradX = g.X if grad_X else jnp.zeros_like(params.X)
    if grad_cov:
        gradCov = jnp.concatenate(
            [jnp.reshape(g.noise_var, (1,)), g.wfn_params, g.dfn_params]
        ).reshape(1, -1)
    else:
        ncov = 1 + params.wfn_params.shape[0] + params.dfn_params.shape[0]
        gradCov = jnp.zeros((1, ncov), dtype=params.X.dtype)
    return ll, gradX, gradCov
