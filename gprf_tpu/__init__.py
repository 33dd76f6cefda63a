"""gprf_tpu: Gaussian Process Random Fields in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of davmre/gprf
(Moore & Russell, "Gaussian Process Random Fields", NIPS 2015).

The reference implements the block-factored GP approximation

    log p(Y|X, theta) ~= sum_{(i,j) in E} log p(Y_i, Y_j)
                         - sum_i (|E_i| - 1) log p(Y_i)

with per-block dense LAPACK linear algebra and hand-coded derivative chain
rules in C++ (treegp).  Here every block term is a masked, padded Gaussian
log-density evaluated by one batched Cholesky factorization, vmapped over all
blocks and all GPRF edges, differentiated end-to-end with jax.grad, and
shardable over a device mesh.
"""

from gprf_tpu.kernels.gpcov import GPCov
from gprf_tpu.kernels.covfn import kernel_matrix, cross_kernel_matrix
from gprf_tpu.partition.layout import BlockLayout
from gprf_tpu.model.gprf import GPRF
from gprf_tpu.model.objective import GPRFParams, gprf_ll, gprf_ll_schur, gprf_value_and_grad
from gprf_tpu.model.fullgp import GP, mcov, prior_sample
from gprf_tpu.model.fused import FusedGridGPRF

__version__ = "0.1.0"

__all__ = [
    "GPCov",
    "kernel_matrix",
    "cross_kernel_matrix",
    "BlockLayout",
    "GPRF",
    "GPRFParams",
    "gprf_ll",
    "gprf_ll_schur",
    "gprf_value_and_grad",
    "GP",
    "mcov",
    "prior_sample",
    "FusedGridGPRF",
]
