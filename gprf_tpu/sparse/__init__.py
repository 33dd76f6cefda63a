"""Sparse kernel linear algebra (large-n path).

Native replacement for the reference's cover-tree + CHOLMOD stack
(``VectorTree.sparse_training_kernel_matrix`` / ``scikits.sparse.cholmod``,
used at ``gprf.py:378-494`` and ``synthetic.py:115-135``): a native C++
kd-tree fixed-radius range query builds the sparse kernel pattern, and a
native C++ up-looking sparse Cholesky factors it for sampling, solves, and
log-determinants.  See ``csrc/`` and :mod:`gprf_tpu.sparse.native`.
"""

from gprf_tpu.sparse.ops import (
    sparse_kernel_matrix,
    sample_y_banded,
    sample_y_sparse,
    SparseFactor,
)

__all__ = [
    "sparse_kernel_matrix",
    "sample_y_banded",
    "sample_y_sparse",
    "SparseFactor",
]
