"""Host-facing GPRF model: stateful wrapper over the jitted objective.

API mirror of the reference ``GPRF`` class (``gprf.py:83-746``) so the
optimization drivers, analysis tooling, and tests translate one-to-one:
``llgrad``, ``update_X``, ``update_covs``, ``compute_neighbors``,
``train_predictor``, ``llgrad_unary`` / ``llgrad_joint``.  Internally all
compute is a single jit-compiled batched objective
(:mod:`gprf_tpu.model.objective`) over a static padded
:class:`~gprf_tpu.partition.layout.BlockLayout`; re-blocking on ``update_X``
replays the partitioner's fixed splits on host and only refreshes the gather
tensors (shapes stay fixed, so no retrace).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from gprf_tpu.kernels.covfn import cross_kernel_matrix, kernel_matrix
from gprf_tpu.kernels.gpcov import GPCov
from gprf_tpu.model.neighbors import compute_neighbors as _compute_neighbors
from gprf_tpu.model.objective import (
    GPRFParams,
    gprf_value_and_grad,
    gprf_value_and_grad_schur,
)
from gprf_tpu.partition.layout import BlockLayout

_MB = 1024 * 1024


def _auto_chunk(n_items: int, width: int, budget_bytes: int = 512 * _MB) -> int | None:
    """Pick a lax.map batch size so ~10 live [chunk, width, width] f32
    buffers fit in the budget; None means vmap everything at once.  The
    budget is a memory bound, not a tuned speed setting."""
    per_item = width * width * 4 * 10
    if n_items * per_item <= budget_bytes:
        return None
    return max(8, budget_bytes // per_item)


class GPRF:
    """Block-factored GP random field over latent inputs X and outputs Y.

    Parameters mirror the reference constructor (``gprf.py:85-117``):

    X : [n, dx] latent input locations (host NumPy; mutated by update_X)
    Y : [n, dy] observations
    block_fn : callable X -> list of index arrays (replayable partitioner),
        or None to freeze the initial partition
    cov : GPCov kernel hyperparameters
    noise_var : observation noise variance
    neighbor_threshold : max-correlation threshold for adding an edge
        (1.0 => no edges => independent local GPs)
    block_idxs / neighbors : optionally precomputed partition / edge list
    kernelized, dy : second-moment-observation mode — Y is the [n, n] outer
        product matrix YY^T instead of raw features (reference
        ``gaussian_llgrad_kernel``, ``gprf.py:674-736``)
    """

    def __init__(
        self,
        X,
        Y,
        block_fn,
        cov: GPCov,
        noise_var,
        kernelized: bool = False,
        dy: int | None = None,
        nonstationary: bool = False,
        neighbor_threshold: float = 1e-3,
        block_idxs=None,
        neighbors=None,
        pad_multiple: int = 8,
        unary_chunk: int | None = None,
        pair_chunk: int | None = None,
        form: str = "schur",
        mesh=None,
    ):
        if nonstationary:
            # the reference's nonstationary paths reference never-assigned
            # state (gprf.py:649-650, 279-284) — dead upstream, rejected here
            raise NotImplementedError(
                "nonstationary GPRF is an incomplete feature in the reference "
                "implementation and is not supported"
            )
        self.nonstationary = False
        self.X = np.asarray(X, dtype=np.float64).copy()
        self.kernelized = kernelized
        if kernelized:
            assert dy is not None
            self.dy = dy
            self.YY = np.asarray(Y)
            self._Y_dev = jnp.asarray(self.YY)
        else:
            self.Y = np.asarray(Y)
            self._Y_dev = jnp.asarray(self.Y)
        self.cov = cov
        self.noise_var = float(noise_var)
        self.block_fn = block_fn
        self.neighbor_threshold = float(neighbor_threshold)
        self.pad_multiple = pad_multiple
        self._unary_chunk = unary_chunk
        self._pair_chunk = pair_chunk
        assert form in ("schur", "joint")
        self.form = form  # "schur" = fast default; "joint" = parity oracle
        self.mesh = mesh  # optional jax.sharding.Mesh for multi-chip llgrad

        if block_idxs is None:
            block_idxs = block_fn(self.X)
        self.n_blocks = len(block_idxs)
        self._pad_to = None  # set by first layout build
        self._build_layout(block_idxs, edges=None)

        if neighbors is not None:
            self.neighbors = [(int(i), int(j)) for (i, j) in neighbors]
        else:
            self.neighbors = self.compute_neighbors(threshold=self.neighbor_threshold)
        self._set_edges(self.neighbors)
        self._all_pairs_arrays = None

    # ----- layout management -------------------------------------------------

    def _build_layout(self, block_idxs, edges):
        layout = BlockLayout.from_blocks(
            block_idxs,
            n=len(self.X),
            edges=edges,
            pad_multiple=self.pad_multiple,
            pad_to=self._pad_to,
        )
        self._pad_to = layout.block_pad
        self.layout = layout
        self._arrays = None  # invalidate device cache

    def _set_edges(self, edges):
        self.neighbors = list(edges)
        self._build_layout(self.layout.block_idxs(), edges)
        self.neighbor_count = {
            i: int(c) for i, c in enumerate(self.layout.neighbor_count)
        }

    def _device_arrays(self):
        if self._arrays is None:
            self._arrays = self.layout.device_arrays()
        return self._arrays

    @property
    def block_idxs(self):
        return self.layout.block_idxs()

    # ----- reference API -----------------------------------------------------

    def compute_neighbors(self, threshold: float = 1e-3):
        """Edge discovery by batched max cross-correlation
        (see :mod:`gprf_tpu.model.neighbors`)."""
        arrays = self._device_arrays()
        return _compute_neighbors(
            jnp.asarray(self.X),
            arrays["assignment"],
            arrays["mask"],
            self.cov,
            threshold=threshold,
        )

    def update_covs(self, covs):
        """Install a reference-style full cov row [[nv, sv, l1, l2, ...]]
        (``gprf.py:160-167`` semantics)."""
        covs = np.asarray(covs, dtype=np.float64)
        nv, sv = covs[0, :2]
        lscales = covs[0, 2:]
        self.cov = GPCov(
            wfn_params=jnp.asarray([sv]),
            dfn_params=jnp.asarray(lscales),
            dfn_str=self.cov.dfn_str,
            wfn_str=self.cov.wfn_str,
        )
        self.noise_var = float(nv)

    def update_X(self, new_X, update_blocks: bool = True, recompute_neighbors: bool = False):
        """Install new latent locations, replaying the partitioner's fixed
        splits (reference ``gprf.py:169-174``)."""
        self.X = np.asarray(new_X, dtype=np.float64).copy()
        if update_blocks and self.block_fn is not None:
            block_idxs = self.block_fn(self.X)
            max_sz = max(len(ix) for ix in block_idxs)
            if max_sz > self._pad_to:
                # block grew past the padded slot count: rebuild wider
                # (rare; forces one retrace)
                self._pad_to = None
            self._build_layout(block_idxs, self.neighbors)
        if recompute_neighbors:
            self._set_edges(self.compute_neighbors(threshold=self.neighbor_threshold))

    def update_X_block(self, i, new_X_block):
        idxs = self.layout.block_idxs()[i]
        self.X[idxs] = new_X_block

    def _params(self, dtype=None):
        return GPRFParams(
            X=jnp.asarray(self.X, dtype=dtype),
            wfn_params=jnp.asarray(self.cov.wfn_params, dtype=dtype),
            dfn_params=jnp.asarray(self.cov.dfn_params, dtype=dtype),
            noise_var=jnp.asarray(self.noise_var, dtype=dtype),
        )

    def llgrad(
        self,
        grad_X: bool = False,
        grad_cov: bool = False,
        local: bool = True,
        parallel: bool = False,  # accepted for API parity; the device path always batches
        sparse: bool = False,  # truncated-support sparse path (native Cholesky + Takahashi)
        **_ignored,
    ):
        """(ll, gradX, gradCov) — the reference ``llgrad`` contract
        (``gprf.py:206-296``).  ``local=False`` uses the fully-connected
        pairwise objective (all block pairs)."""
        if sparse:
            return self._llgrad_sparse(grad_X, grad_cov, local)
        if local:
            arrays = self._device_arrays()
        else:
            arrays = self._all_pairs_device_arrays()
        if self.kernelized:
            return self._llgrad_kernelized(arrays, grad_X, grad_cov)
        if self.form == "schur":
            # fast default: pair terms factored through the unary Cholesky
            # (8x fewer factorization flops)
            ll, gX, gC = gprf_value_and_grad_schur(
                self._params(),
                self._Y_dev,
                arrays["assignment"],
                arrays["mask"],
                arrays["edges"],
                arrays["unary_weights"],
                arrays["pair_weights"],
                dfn_str=self.cov.dfn_str,
                wfn_str=self.cov.wfn_str,
                grad_X=grad_X,
                grad_cov=grad_cov,
                pair_chunk=self._pair_chunk_for(arrays),
                mesh=self.mesh,
            )
        else:
            ll, gX, gC = gprf_value_and_grad(
                self._params(),
                self._Y_dev,
                arrays["assignment"],
                arrays["mask"],
                arrays["pair_assignment"],
                arrays["pair_mask"],
                arrays["unary_weights"],
                arrays["pair_weights"],
                dfn_str=self.cov.dfn_str,
                wfn_str=self.cov.wfn_str,
                grad_X=grad_X,
                grad_cov=grad_cov,
                unary_chunk=self._unary_chunk_for(arrays),
                pair_chunk=self._pair_chunk_for(arrays),
            )
        # one batched device_get (separate fetches each pay a transport
        # round-trip); np.array copies because device views are read-only
        # and the drivers mutate gradients in place (depth rescaling etc.)
        ll, gX, gC = jax.device_get((ll, gX, gC))
        return float(ll), np.array(gX), np.array(gC)

    def _unary_chunk_for(self, arrays):
        if self._unary_chunk is not None:
            return self._unary_chunk
        return _auto_chunk(arrays["assignment"].shape[0], arrays["assignment"].shape[1])

    def _pair_chunk_for(self, arrays):
        if self._pair_chunk is not None:
            return self._pair_chunk
        return _auto_chunk(
            arrays["pair_assignment"].shape[0], max(arrays["pair_assignment"].shape[-1], 1)
        )

    def _all_pairs_device_arrays(self):
        if self._all_pairs_arrays is None:
            B = self.n_blocks
            edges = [(i, j) for i in range(B) for j in range(i)]
            layout = BlockLayout.from_blocks(
                self.layout.block_idxs(), n=len(self.X), edges=edges, pad_to=self._pad_to
            )
            self._all_pairs_arrays = layout.device_arrays()
        return self._all_pairs_arrays

    def subset_llgrad(self, blocks):
        """Objective restricted to a subset of blocks: unaries in the subset
        plus pairs within it, with subset-local neighbor counts (reference
        ``gprf.py:182-204``)."""
        block_set = set(int(b) for b in blocks)
        neighbors_in_set = [
            (i, j) for (i, j) in self.neighbors if i in block_set and j in block_set
        ]
        local_counts = {b: 0 for b in block_set}
        for i, j in neighbors_in_set:
            local_counts[i] += 1
            local_counts[j] += 1
        ll = 0.0
        for b in blocks:
            ull = self.llgrad_unary(int(b))[0]
            ll += (1 - local_counts[int(b)]) * ull
        for i, j in neighbors_in_set:
            ll += self.llgrad_joint(i, j)[0]
        return ll

    # single-term entry points, mainly for tests / parity checks ------------

    def llgrad_unary(self, i, grad_X=False, grad_cov=False, **_):
        idxs = self.layout.block_idxs()[i]
        return self.gaussian_llgrad(self.X[idxs], self.Y[idxs], grad_X=grad_X, grad_cov=grad_cov)

    def llgrad_joint(self, i, j, grad_X=False, grad_cov=False, **_):
        idxs = self.layout.block_idxs()[i]
        jdxs = self.layout.block_idxs()[j]
        X = np.vstack([self.X[idxs], self.X[jdxs]])
        Y = np.vstack([self.Y[idxs], self.Y[jdxs]])
        return self.gaussian_llgrad(X, Y, grad_X=grad_X, grad_cov=grad_cov)

    def gaussian_llgrad(self, X, Y, grad_X=False, grad_cov=False):
        """Single dense Gaussian term (reference ``gprf.py:496-591``),
        evaluated through the same masked batched code path (batch of 1,
        full mask)."""
        n = X.shape[0]
        if n == 0:
            ncov = 2 + len(self.cov.dfn_params)
            return 0.0, np.zeros(X.shape), np.zeros((ncov,))
        assignment = jnp.arange(n, dtype=jnp.int32).reshape(1, n)
        mask = jnp.ones((1, n), dtype=bool)
        empty_pa = jnp.zeros((0, 2 * n), dtype=jnp.int32)
        empty_pm = jnp.zeros((0, 2 * n), dtype=bool)
        params = GPRFParams(
            X=jnp.asarray(X),
            wfn_params=jnp.asarray(self.cov.wfn_params),
            dfn_params=jnp.asarray(self.cov.dfn_params),
            noise_var=jnp.asarray(self.noise_var, dtype=jnp.asarray(X).dtype),
        )
        ll, gX, gC = gprf_value_and_grad(
            params,
            jnp.asarray(Y),
            assignment,
            mask,
            empty_pa,
            empty_pm,
            jnp.ones((1,), dtype=jnp.asarray(X).dtype),
            jnp.zeros((0,), dtype=jnp.asarray(X).dtype),
            dfn_str=self.cov.dfn_str,
            wfn_str=self.cov.wfn_str,
            grad_X=grad_X,
            grad_cov=grad_cov,
        )
        return float(ll), np.array(gX), np.array(gC).reshape(-1)

    # kernel evaluation helpers (reference ``gprf.py:333-343``) -------------

    def kernel(self, X, X2=None):
        if X2 is None:
            return np.asarray(kernel_matrix(self.cov, jnp.asarray(X), noise_var=self.noise_var))
        return np.asarray(cross_kernel_matrix(self.cov, jnp.asarray(X), jnp.asarray(X2)))

    def _llgrad_sparse(self, grad_X, grad_cov, local, max_distance=5.0):
        """Per-block truncated-support sparse path (reference ``--sparse``,
        ``gprf.py:378-494``): host loop over unary and pair terms through
        the native sparse Cholesky + selected inverse."""
        from gprf_tpu.model.sparse_llgrad import gaussian_llgrad_sparse

        if local:
            neighbors = self.neighbors
            counts = self.neighbor_count
        else:
            B = self.n_blocks
            neighbors = [(i, j) for i in range(B) for j in range(i)]
            counts = {i: B - 1 for i in range(B)}
        blocks = self.layout.block_idxs()
        ncov = 2 + len(np.asarray(self.cov.dfn_params))
        ll = 0.0
        gradX = np.zeros(self.X.shape)
        gradC = np.zeros((1, ncov))

        def term(idxs):
            return gaussian_llgrad_sparse(
                self.X[idxs], self.Y[idxs], self.cov, self.noise_var,
                grad_X=grad_X, grad_cov=grad_cov, max_distance=max_distance,
            )

        for b, idxs in enumerate(blocks):
            w = 1 - counts.get(b, 0)
            tll, tgX, tgC = term(idxs)
            ll += w * tll
            if grad_X:
                gradX[idxs] += w * tgX
            if grad_cov:
                gradC[0] += w * tgC
        for i, j in neighbors:
            idxs = np.concatenate([blocks[i], blocks[j]])
            tll, tgX, tgC = term(idxs)
            ll += tll
            if grad_X:
                gradX[idxs] += tgX
            if grad_cov:
                gradC[0] += tgC
        if not grad_X:
            gradX = np.zeros(self.X.shape)
        return float(ll), gradX, gradC

    def _llgrad_kernelized(self, arrays, grad_X, grad_cov):
        from gprf_tpu.model.kernelized import kernelized_value_and_grad

        ll, gX, gC = kernelized_value_and_grad(
            self._params(),
            self._Y_dev,
            arrays["assignment"],
            arrays["mask"],
            arrays["pair_assignment"],
            arrays["pair_mask"],
            arrays["unary_weights"],
            arrays["pair_weights"],
            dy=self.dy,
            dfn_str=self.cov.dfn_str,
            wfn_str=self.cov.wfn_str,
            grad_X=grad_X,
            grad_cov=grad_cov,
        )
        # one batched device_get (separate fetches each pay a transport
        # round-trip); np.array copies because device views are read-only
        # and the drivers mutate gradients in place (depth rescaling etc.)
        ll, gX, gC = jax.device_get((ll, gX, gC))
        return float(ll), np.array(gX), np.array(gC)

    def train_predictor(self, test_cov=None, Y=None):
        from gprf_tpu.model.predict import train_predictor

        return train_predictor(self, test_cov=test_cov, Y=Y)
