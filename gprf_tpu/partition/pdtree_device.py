"""Device-side PD-tree replay: block assignment as pure JAX compute.

The PD-tree's split replay (``PDTree.recluster``, reference
``pdtree_clustering.py:65-77``) is threshold-based — each inner node stores
a split direction, center, and scalar threshold — so re-blocking a moved
point cloud is a root-to-leaf traversal per point: D rounds of
``a = (x - center_v) . vec_v;  v <- left if a < split else right``.  This
module flattens a host-built :class:`~gprf_tpu.partition.pdtree.PDTree`
into arrays and evaluates the traversal for all points in a fixed-depth
``fori_loop`` — which makes the full seismic per-step evaluation (re-block,
gather, objective, priors, gradients) a single device program, like the
grid path in :mod:`gprf_tpu.model.fused`.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from gprf_tpu.partition.pdtree import PDTree, _Leaf


class FlatPDTree:
    """Array form of a PDTree over dim-d coordinates.

    Node arrays (N nodes, node 0 = root):
      split_vec [N, d], center [N, d], split [N],
      left/right [N] (child node ids; self-loops at leaves),
      leaf_block [N] (block id at leaves, -1 at inner nodes),
      depth: max root-to-leaf length.
    """

    def __init__(self, tree: PDTree):
        nodes = []

        def walk(node, depth):
            my_id = len(nodes)
            nodes.append(None)  # placeholder
            if isinstance(node, _Leaf):
                nodes[my_id] = ("leaf", node, depth)
                return my_id, depth
            lid, dl = walk(node.left, depth + 1)
            rid, dr = walk(node.right, depth + 1)
            nodes[my_id] = ("inner", node, depth, lid, rid)
            return my_id, max(dl, dr)

        _, self.depth = walk(tree.tree, 0)
        N = len(nodes)
        d = tree.X.shape[1]
        self.split_vec = np.zeros((N, d))
        self.center = np.zeros((N, d))
        self.split = np.zeros((N,))
        self.left = np.arange(N, dtype=np.int32)
        self.right = np.arange(N, dtype=np.int32)
        self.leaf_block = np.full((N,), -1, dtype=np.int32)
        n_blocks = 0
        for i, rec in enumerate(nodes):
            if rec[0] == "leaf":
                self.leaf_block[i] = n_blocks
                n_blocks += 1
            else:
                _, node, _, lid, rid = rec
                self.split_vec[i] = node.split_vec
                self.center[i] = node.center
                self.split[i] = node.split
                self.left[i] = lid
                self.right[i] = rid
        self.n_blocks = n_blocks

    def device_arrays(self, dtype=jnp.float32):
        # one packed node table [N, 2d+3]: a traversal level then costs ONE
        # dynamic gather instead of five (gathers dominated the re-block's
        # device time at the 12k seismic step on an earlier accelerator)
        d = self.split_vec.shape[1]
        packed = np.concatenate(
            [
                self.split_vec,
                self.center,
                self.split[:, None],
                self.left[:, None].astype(np.float64),
                self.right[:, None].astype(np.float64),
            ],
            axis=1,
        )
        return dict(
            packed=jnp.asarray(packed, dtype=dtype),
            d=d,
            split_vec=jnp.asarray(self.split_vec, dtype=dtype),
            center=jnp.asarray(self.center, dtype=dtype),
            split=jnp.asarray(self.split, dtype=dtype),
            left=jnp.asarray(self.left),
            right=jnp.asarray(self.right),
            leaf_block=jnp.asarray(self.leaf_block),
        )


def assign_blocks_pdtree(X2, arrays, depth: int):
    """Block id per point for dim-matched coordinates X2 [n, d].

    Wrap-around/column selection (the seismic (lon+22)%360-22 wrap on
    (lon, lat), ``pdtree_clustering.py:79-94``) is the caller's concern.
    """
    n = X2.shape[0]
    cur = jnp.zeros((n,), dtype=jnp.int32)

    packed = arrays.get("packed")
    if packed is not None:
        # unrolled static-depth traversal, ONE gather per level from the
        # packed node table (vs five gathers in a fori_loop body, which
        # XLA cannot fuse across iterations)
        d = arrays["d"]
        for _ in range(depth):
            row = packed[cur]  # [n, 2d+3]
            vec = row[:, :d]
            ctr = row[:, d : 2 * d]
            split = row[:, 2 * d]
            a = jnp.sum((X2 - ctr) * vec, axis=1)
            go_left = a < split
            cur = jnp.where(go_left, row[:, 2 * d + 1], row[:, 2 * d + 2]).astype(
                jnp.int32
            )
        return arrays["leaf_block"][cur]

    def step(_, cur):
        vec = arrays["split_vec"][cur]  # [n, d]
        ctr = arrays["center"][cur]
        a = jnp.sum((X2 - ctr) * vec, axis=1)
        go_left = a < arrays["split"][cur]
        nxt = jnp.where(go_left, arrays["left"][cur], arrays["right"][cur])
        return nxt

    cur = jax.lax.fori_loop(0, depth, step, cur)
    return arrays["leaf_block"][cur]
