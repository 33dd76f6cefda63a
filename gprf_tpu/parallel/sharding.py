"""Multi-chip execution: block/edge batches sharded over a device mesh.

The reference's only intra-job parallelism is a fork-based process pool over
blocks (``gprf.py:218-229``), with each task pickling the whole model.  The
device-mesh equivalent: the unary block batch ``[B, m]`` and the edge batch
``[E, 2m]`` are sharded along their leading axis over a 1-d ``Mesh`` axis
``"b"``; X, Y, and the hyperparameters are replicated.  The objective is the
exact same jit-compiled function as the single-chip path
(:func:`gprf_tpu.model.objective.gprf_value_and_grad`) — GSPMD partitions
the vmapped batch automatically from the input shardings, and the
gather-transpose that produces gradX becomes a local partial scatter-add
followed by a compiler-inserted AllReduce over "b".  The same
AllReduce covers the scalar objective and the hyperparameter gradients.

Requirements on the layout: both batch sizes must be multiples of the mesh
size — :func:`shard_layout_arrays` pads with zero-weight dummy entries
(weights are part of the objective, so padding is exact, not approximate).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gprf_tpu.model.objective import gprf_value_and_grad


def make_mesh(devices=None, axis_name: str = "b") -> Mesh:
    """1-d mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices).reshape(-1), (axis_name,))


def _round_up(x: int, mult: int) -> int:
    return ((max(x, 1) + mult - 1) // mult) * mult


def shard_layout_arrays(layout, mesh: Mesh, axis_name: str = "b"):
    """Device-put the layout tensors with batch axes sharded over the mesh.

    Returns the dict expected by the objective, with unary and edge batches
    padded to multiples of the mesh size (dummy entries carry zero weight)
    and placed with NamedSharding(P("b")); replicated tensors are left to
    the jit to place.
    """
    ndev = mesh.devices.size
    B = layout.n_blocks
    E = layout.n_edges
    arrays = layout.device_arrays(pad_edges_to=_round_up(E, ndev) if E else None)

    padB = _round_up(B, ndev)
    if padB > B:
        m = layout.block_pad
        arrays["assignment"] = jnp.concatenate(
            [arrays["assignment"], jnp.zeros((padB - B, m), dtype=jnp.int32)]
        )
        arrays["mask"] = jnp.concatenate(
            [arrays["mask"], jnp.zeros((padB - B, m), dtype=bool)]
        )
        arrays["unary_weights"] = jnp.concatenate(
            [arrays["unary_weights"], jnp.zeros((padB - B,), dtype=arrays["unary_weights"].dtype)]
        )

    batch_sharding = NamedSharding(mesh, P(axis_name))
    for key in ("assignment", "mask", "unary_weights"):
        arrays[key] = jax.device_put(arrays[key], batch_sharding)
    if arrays["pair_assignment"].shape[0] > 0:
        for key in ("pair_assignment", "pair_mask", "pair_weights", "edges"):
            arrays[key] = jax.device_put(arrays[key], batch_sharding)
    return arrays


def sharded_gprf_value_and_grad(
    params,
    Y,
    sharded_arrays,
    mesh: Mesh,
    dfn_str: str = "euclidean",
    wfn_str: str = "se",
    grad_X: bool = True,
    grad_cov: bool = False,
):
    """(ll, gradX, gradCov) with the batches sharded over ``mesh``.

    Thin wrapper: replicates params/Y onto the mesh and calls the standard
    objective; GSPMD inserts the collectives.  Outputs are fully replicated.
    """
    replicated = NamedSharding(mesh, P())
    params = jax.device_put(params, replicated)
    Y = jax.device_put(Y, replicated)
    return gprf_value_and_grad(
        params,
        Y,
        sharded_arrays["assignment"],
        sharded_arrays["mask"],
        sharded_arrays["pair_assignment"],
        sharded_arrays["pair_mask"],
        sharded_arrays["unary_weights"],
        sharded_arrays["pair_weights"],
        dfn_str=dfn_str,
        wfn_str=wfn_str,
        grad_X=grad_X,
        grad_cov=grad_cov,
    )
