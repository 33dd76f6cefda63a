"""BCM-style prediction from a trained GPRF.

Rebuild of the reference ``GPRF.train_predictor`` (``gprf.py:593-672``): each
block acts as a local GP expert; a query is answered by the blocks containing
the query points plus their GPRF neighbors, combined in precision
(natural-parameter) space — a product-of-experts/Bayesian-committee-machine
correction against the shared prior:

    message_prec_i = inv(post_cov_i) - inv(Kss)
    final_prec     = inv(prior_cov) + sum_i message_prec_i
    final_mean     = inv(final_prec) sum_i inv(post_cov_i) post_mean_i

Per-block training caches (chol(K), alpha) are computed in one batched masked
Cholesky pass on device; query-time K*·K⁻¹·K*ᵀ products are Cholesky solves
against the q-sized query RHS, never an explicit m×m inverse (which does not
even compile on-chip at the single-block full-GP width m=10048).  The query-time combination is also one batched
device program (``combine="device"``, the default): the source blocks are
gathered into a padded [S, m] batch and every per-expert posterior,
precision (Cholesky-solve, no explicit ``np.linalg.inv``), and the
precision-weighted pooling run as a single vmapped dispatch — replacing the
reference's per-source-block host loop (``gprf.py:644-665``).  The host
NumPy loop is kept as the parity oracle (``combine="host"``).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsp_linalg

from gprf_tpu.kernels.covfn import cross_kernel_matrix
from gprf_tpu.kernels.gpcov import GPCov
from gprf_tpu.linalg.masked import pad_kernel_matrix


@jax.jit
def _block_caches(X, Y, assignment, mask, cov: GPCov, noise_var):
    """Batched per-block (L, alpha): the Cholesky factor of the
    (identity-padded) block kernel and the masked solve against Y.

    Replaces the reference per-block ``np.linalg.inv`` loop
    (``gprf.py:606-617``).  The factor is cached INSTEAD of the explicit
    inverse the reference stored: query-time products K*·K⁻¹·K*ᵀ become
    ``cho_solve`` against the q-sized query RHS, which (a) is the
    standard backward-stable formulation and (b) keeps the largest
    buffer O(m·q) instead of O(m²) RHS — the explicit m×m inverse ran
    out of device memory at the full-GP single-block width (m=10048) on an
    earlier accelerator, where the bare Cholesky ran fine.  Module-level
    jit: the per-step analysis
    loop builds a fresh predictor per row and must hit the compile
    cache.
    """

    def one(idx, msk):
        Xb = X[idx]
        Yb = Y[idx] * msk[:, None].astype(Y.dtype)
        K = cross_kernel_matrix(cov, Xb, Xb)
        K = K + noise_var * jnp.eye(K.shape[-1], dtype=K.dtype)
        Kp = pad_kernel_matrix(K, msk)
        L = jsp_linalg.cholesky(Kp, lower=True)
        maskf = msk.astype(K.dtype)
        alpha = jsp_linalg.cho_solve((L, True), Yb) * maskf[:, None]
        return L, alpha

    return jax.vmap(one)(assignment, mask)


def symmetrize_neighbors(neighbors):
    ndict = defaultdict(set)
    for i, j in neighbors:
        ndict[i].add(j)
        ndict[j].add(i)
    return ndict


@jax.jit
def _combine_device(
    Xstar, Xs, Ls_s, Alphas_s, masks_s, model_cov: GPCov,
    test_cov: GPCov, expert_nv, prior_nv
):
    """One-dispatch BCM combination over a padded source-block batch.

    Xstar [q, dx]; Xs [S, m, dx]; Ls_s [S, m, m] (block-kernel Cholesky
    factors); Alphas_s [S, m, dy]; masks_s [S, m] — returns
    (final_mean [q, dy], final_cov [q, q]).  Expert posterior precisions
    come from a batched Cholesky solve; a dummy expert slot is any slot
    whose mask is all-zero and whose L is a VALID factor (a gathered real
    block's L, or identity) — its Kstar is zeroed so its message
    prec − pp cancels exactly.  The prior uses ``test_cov``, the experts
    the model covariance (reference ``gprf.py:621, 649-656``).
    """
    q = Xstar.shape[0]
    dtype = Xstar.dtype
    eye = jnp.eye(q, dtype=dtype)
    prior_cov = cross_kernel_matrix(test_cov, Xstar, Xstar) + eye * prior_nv
    # reference quirk preserved (gprf.py:655-656): each expert's Kss gets
    # the *model* noise variance when test noise is requested
    Kss = cross_kernel_matrix(model_cov, Xstar, Xstar) + eye * expert_nv

    maskf = masks_s.astype(dtype)

    def expert(Xi, Lb, alpha, msk):
        Kstar = cross_kernel_matrix(model_cov, Xstar, Xi) * msk[None, :]
        mean = Kstar @ alpha  # [q, dy]
        # K*·K⁻¹·K*ᵀ via cho_solve against the q RHS columns: identity-
        # padded L rows solve masked (zero) Kstar columns to exact zeros
        cov_post = Kss - Kstar @ jsp_linalg.cho_solve((Lb, True), Kstar.T)
        L = jsp_linalg.cholesky(cov_post, lower=True)
        prec = jsp_linalg.cho_solve((L, True), eye)
        return prec, prec @ mean

    with jax.default_matmul_precision("highest"):
        precs, wmeans = jax.vmap(expert)(Xs, Ls_s, Alphas_s, maskf)
        S = Xs.shape[0]
        Lss = jsp_linalg.cholesky(Kss, lower=True)
        pp = jsp_linalg.cho_solve((Lss, True), eye)
        Lp = jsp_linalg.cholesky(prior_cov, lower=True)
        prior_prec = jsp_linalg.cho_solve((Lp, True), eye)
        final_prec = prior_prec + jnp.sum(precs, axis=0) - S * pp
        prior_mean = jnp.sum(wmeans, axis=0)
        final_cov = jnp.linalg.inv(final_prec)
        final_mean = final_cov @ prior_mean
    return final_mean, final_cov


# module-level so the compile cache is shared across train_block_predictor
# calls (the per-step analysis loop builds a fresh predictor per row)
_combine_device_batched = jax.jit(
    jax.vmap(_combine_device, in_axes=(0, 0, 0, 0, 0, None, None, None, None))
)


def train_block_predictor(gprf, test_cov: GPCov | None = None, Y=None,
                          dtype=None):
    """Whole-test-set BCM prediction in ONE device dispatch.

    The per-call predictor (:func:`train_predictor`) answers one query
    batch per dispatch; analysis loops (``SampledData.prediction_error``)
    call it once per test block, which costs a dispatch and a host round
    trip each plus a compile per distinct shape.  Here the partition IS the query structure: test
    block t is answered by experts {t} + neighbors(t), so all T blocks
    pad to a common (qmax, Smax) and one vmapped
    :func:`_combine_device` evaluates every block's posterior at once.

    Returns ``predict_blocks(test_blocks, Xtest, test_noise_var=0.0)`` ->
    dict {block_id: (mean [q_t, dy], cov [q_t, q_t])} for non-empty
    blocks.  Query padding uses far-away points whose SE/Matern cross
    kernel underflows to exactly zero (euclidean distances only — the
    synthetic analysis path); source padding uses exact zero-message
    dummy experts.  ``dtype`` defaults to the default float type
    (f64 under x64).
    """
    if Y is None:
        Y = gprf.Y
    Y = np.asarray(Y)
    if test_cov is None:
        test_cov = gprf.cov
    assert gprf.cov.dfn_str == "euclidean", (
        "batched block prediction pads queries with far points; only "
        "euclidean kernels guarantee exact cross-kernel underflow"
    )
    if dtype is None:
        dtype = jnp.result_type(float)

    arrays = gprf.layout.device_arrays()
    X_snap = np.array(gprf.X, copy=True)
    Ls, Alphas = _block_caches(
        jnp.asarray(X_snap, dtype=dtype),
        jnp.asarray(Y, dtype=dtype),
        arrays["assignment"],
        arrays["mask"],
        jax.tree.map(lambda a: jnp.asarray(a, dtype=dtype), gprf.cov),
        jnp.asarray(gprf.noise_var, dtype=dtype),
    )
    # the [B, m, m] caches STAY on device: at wide m they are hundreds of
    # MB (m=10048: 404 MB per factor) and fetching them to the host per
    # analysis row is pure transfer; the source-block gather below runs on
    # device
    mask_dev = arrays["mask"]
    Xpad_dev = jnp.asarray(X_snap, dtype=dtype)[arrays["assignment"]]
    assignment = np.asarray(arrays["assignment"])
    m = assignment.shape[1]
    dx = X_snap.shape[1]
    neighbor_dict = symmetrize_neighbors(gprf.neighbors)

    combine_b = _combine_device_batched

    def predict_blocks(test_blocks, Xtest, test_noise_var: float = 0.0):
        Xtest = np.asarray(Xtest)
        active = [t for t, idxs in enumerate(test_blocks) if len(idxs) > 0]
        T = len(active)
        if T == 0:
            return {}
        qmax = -(-max(len(test_blocks[t]) for t in active) // 8) * 8
        srcs = [sorted({t} | neighbor_dict[t]) for t in active]
        Smax = max(2, max(len(s) for s in srcs))

        Xq = np.zeros((T, qmax, dx))
        src_idx = np.zeros((T, Smax), dtype=np.int32)
        src_valid = np.zeros((T, Smax), dtype=bool)
        for a, t in enumerate(active):
            idxs = np.asarray(test_blocks[t])
            q = len(idxs)
            Xq[a, :q] = Xtest[idxs]
            if q < qmax:  # far points: cross kernel underflows to 0
                Xq[a, q:] = Xq[a, 0]
                Xq[a, q:, 0] += 1e5 * (1.0 + np.arange(qmax - q))
            S = len(srcs[a])
            src_idx[a, :S] = srcs[a]
            src_valid[a, :S] = True

        # device-side gather: padded slots replay block src_idx=0 (a real,
        # valid Cholesky factor) with an all-zero mask — their expert
        # message cancels exactly in _combine_device
        idx_d = jnp.asarray(src_idx)
        Xs_b = Xpad_dev[idx_d]
        Ls_b = Ls[idx_d]
        Alpha_b = Alphas[idx_d]
        mask_b = mask_dev[idx_d] & jnp.asarray(src_valid)[:, :, None]

        expert_nv = gprf.noise_var if test_noise_var > 0 else 0.0
        cov_d = jax.tree.map(lambda a: jnp.asarray(a, dtype=dtype), gprf.cov)
        tcov_d = jax.tree.map(lambda a: jnp.asarray(a, dtype=dtype), test_cov)
        means, covs = jax.device_get(
            combine_b(
                jnp.asarray(Xq, dtype=dtype),
                Xs_b,
                Ls_b,
                Alpha_b,
                mask_b,
                cov_d,
                tcov_d,
                jnp.asarray(expert_nv, dtype=dtype),
                jnp.asarray(test_noise_var, dtype=dtype),
            )
        )
        out = {}
        for a, t in enumerate(active):
            q = len(test_blocks[t])
            mean = np.array(means[a][:q], dtype=np.float64)
            cov = np.array(covs[a][:q, :q], dtype=np.float64)
            if not (np.all(np.isfinite(mean)) and np.all(np.isfinite(cov))):
                raise np.linalg.LinAlgError(
                    "batched BCM combination produced non-finite values "
                    "for test block %d" % t
                )
            out[t] = (mean, cov)
        return out

    return predict_blocks


def train_predictor(gprf, test_cov: GPCov | None = None, Y=None,
                    combine: str = "device"):
    """Returns ``predict(Xstar, test_noise_var=0.0, local=False)`` giving the
    combined posterior (mean, cov) over Y at query locations Xstar."""
    assert combine in ("device", "host")
    if Y is None:
        Y = gprf.Y
    Y = np.asarray(Y)
    if test_cov is None:
        test_cov = gprf.cov

    arrays = gprf.layout.device_arrays()
    # snapshot contract: the predictor is trained on gprf.X AS OF NOW — the
    # cached (L, alpha) are functions of this X, so both combine modes
    # evaluate query kernels against the same snapshot (a later update_X
    # does not silently mix stale factors with fresh kernels)
    X_snap = np.array(gprf.X, copy=True)
    Ls, Alphas = _block_caches(
        jnp.asarray(X_snap),
        jnp.asarray(Y),
        arrays["assignment"],
        arrays["mask"],
        gprf.cov,
        jnp.asarray(gprf.noise_var),
    )
    block_idxs = gprf.layout.block_idxs()
    sizes = gprf.layout.sizes
    neighbor_dict = symmetrize_neighbors(gprf.neighbors)

    def _source_blocks(Xstar):
        test_block_idxs = gprf.block_fn(Xstar)
        source_blocks = set()
        for i, idxs in enumerate(test_block_idxs):
            if len(idxs) == 0:
                continue
            source_blocks.add(i)
            for j in neighbor_dict[i]:
                source_blocks.add(j)
        return sorted(source_blocks)

    if combine == "device":
        assignment = np.asarray(arrays["assignment"])
        maskh = np.asarray(arrays["mask"])
        Xpad = X_snap[assignment]  # [B, m, dx]
        m = assignment.shape[1]
        euclid = gprf.cov.dfn_str == "euclidean"
        # hoist the device->host copies of the caches out of the per-call
        # closure ([B, m, m] each; copying per predict() would move tens of
        # MB per query batch)
        Ls_h = np.asarray(Ls)
        Alphas_h = np.asarray(Alphas)

        def predict(Xstar, test_noise_var: float = 0.0, local: bool = False):
            Xstar = np.asarray(Xstar)
            q0 = Xstar.shape[0]
            src = np.asarray(_source_blocks(Xstar), dtype=np.int64)
            S0 = len(src)
            # shape bucketing: the analysis loop calls with a different
            # (q, S) per test block; each unique pair is a fresh remote XLA
            # compile.  Pad S with zero-mask dummy experts (exact: their
            # message is prec - pp = 0) and, for euclidean kernels, pad q
            # with far-away query points whose cross-kernel underflows to
            # exactly 0 (block-diagonal final precision; real block
            # unaffected), then crop.
            Sp = max(-(-S0 // 4) * 4, 4)
            L_b = np.zeros((Sp, m, m), dtype=Ls_h.dtype)
            Alpha_b = np.zeros((Sp, m, Alphas_h.shape[2]), dtype=L_b.dtype)
            mask_b = np.zeros((Sp, m), dtype=bool)
            X_b = np.zeros((Sp, m, Xpad.shape[2]), dtype=Xpad.dtype)
            L_b[:S0] = Ls_h[src]
            L_b[S0:] = np.eye(m, dtype=L_b.dtype)  # valid factor, zero mask
            Alpha_b[:S0] = Alphas_h[src]
            mask_b[:S0] = maskh[src]
            X_b[:S0] = Xpad[src]
            if euclid:
                qp = -(-q0 // 32) * 32
                if qp > q0:
                    far = np.tile(Xstar[:1], (qp - q0, 1))
                    far[:, 0] += 1e5 * (1.0 + np.arange(qp - q0))
                    Xq = np.concatenate([Xstar, far], axis=0)
                else:
                    Xq = Xstar
            else:
                Xq = Xstar
            expert_nv = gprf.noise_var if test_noise_var > 0 else 0.0
            mean, cov = _combine_device(
                jnp.asarray(Xq),
                jnp.asarray(X_b),
                jnp.asarray(L_b),
                jnp.asarray(Alpha_b),
                jnp.asarray(mask_b),
                gprf.cov,
                test_cov,
                jnp.asarray(expert_nv, dtype=jnp.result_type(float)),
                jnp.asarray(test_noise_var, dtype=jnp.result_type(float)),
            )
            mean, cov = jax.device_get((mean, cov))
            mean = np.array(mean)[:q0]
            cov = np.array(cov)[:q0, :q0]
            if not (np.all(np.isfinite(mean)) and np.all(np.isfinite(cov))):
                # the host oracle's np.linalg.inv raises here; an unjittered
                # Cholesky of a singular expert posterior (e.g. coincident
                # query points with test_noise_var=0) NaNs silently instead
                raise np.linalg.LinAlgError(
                    "BCM combination produced non-finite values (singular "
                    "expert posterior? coincident query points with "
                    "test_noise_var=0?)"
                )
            return mean, cov

        return predict

    # ---- host-loop oracle (the reference's shape, gprf.py:619-670) --------
    Ls_h = np.asarray(Ls)
    Alphas = np.asarray(Alphas)

    # query-time kernel evaluations are tiny and looped on host; evaluating
    # them on device would pay one transport round-trip each (see
    # gprf_tpu.kernels.hostnp)
    from gprf_tpu.kernels.hostnp import cross_kernel_matrix_np

    def k_np(cov, X1, X2):
        return cross_kernel_matrix_np(cov, X1, X2)

    def predict(Xstar, test_noise_var: float = 0.0, local: bool = False):
        Xstar = np.asarray(Xstar)
        prior_cov = k_np(test_cov, Xstar, Xstar)
        prior_cov = prior_cov + np.eye(len(Xstar)) * test_noise_var
        prior_prec = np.linalg.inv(prior_cov)
        prior_mean = np.zeros((Xstar.shape[0], Y.shape[1]))

        for i in _source_blocks(Xstar):
            nb = int(sizes[i])
            Xi = X_snap[block_idxs[i]]
            # identity padding is block-diagonal, so the leading nb x nb of
            # the padded factor is exactly chol(K_block); rebuild the
            # explicit inverse the reference cached (gprf.py:606-617)
            Lb = Ls_h[i, :nb, :nb]
            Kinv = np.linalg.inv(Lb.T) @ np.linalg.inv(Lb)
            alpha = Alphas[i, :nb]
            Kstar = k_np(gprf.cov, Xstar, Xi)
            Kss = k_np(gprf.cov, Xstar, Xstar)
            if test_noise_var > 0:
                # reference quirk preserved: the per-expert Kss gets the
                # *model* noise variance when test noise is requested
                # (gprf.py:655-656)
                Kss = Kss + np.eye(Kss.shape[0]) * gprf.noise_var
            mean = Kstar @ alpha
            cov_post = Kss - Kstar @ (Kinv @ Kstar.T)
            prec = np.linalg.inv(cov_post)
            pp = np.linalg.inv(Kss)
            prior_prec += prec - pp
            prior_mean += prec @ mean

        final_cov = np.linalg.inv(prior_prec)
        final_mean = final_cov @ prior_mean
        return final_mean, final_cov

    return predict
