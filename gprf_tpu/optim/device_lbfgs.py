"""On-device L-BFGS: the whole optimizer loop inside one jit.

The reference (and our scipy-bridge driver) pays a host<->device round trip
per objective evaluation.  Here S L-BFGS iterations run as one ``lax.scan``
dispatch,
with optimizer state (curvature memory, step scale) round-tripping between
dispatches as a pytree — logging/checkpointing is per-dispatch while the
optimization is one continuous run.

Two runners are provided: :func:`make_scan_lbfgs_runner` (the default —
scan-only, retrospective Armijo, exactly one evaluation per iteration; see
its docstring for why it avoids classic line searches) and :func:`make_lbfgs_runner` (optax's lbfgs with zoom line
search, kept as the textbook reference implementation).
"""

from __future__ import annotations

import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import optax
import optax.tree_utils as otu

from gprf_tpu.utils.io import save_step

# the optimizer's vector products run outside the objective's
# matmul-precision context: pin them to full f32 so the GPU's TF32 default
# cannot round the curvature pairs and the Armijo test
_HIGHEST = jax.lax.Precision.HIGHEST


def make_scan_lbfgs_runner(loss_fn, num_steps: int, memory_size: int = 10,
                           c1: float = 1e-4, eta_shrink: float = 0.5,
                           eta_grow: float = 1.2, aux_fn=None):
    """Scan-only L-BFGS: exactly one loss+grad evaluation per iteration.

    Classic zoom line searches are ``lax.while_loop``s whose bodies re-run
    the objective a data-dependent number of times.  This variant uses
    *retrospective* Armijo control instead: step k evaluates the objective
    at the point proposed by step k-1; if the decrease was insufficient the
    state reverts and the step scale shrinks — so the trial evaluation *is*
    the next iteration's evaluation and the whole optimizer is a fixed
    ``lax.scan`` (compiled, zero per-iteration overhead).  The L-BFGS
    memory only absorbs curvature pairs from accepted steps.

    Returns (init_fn, run_fn); run_fn(carry) -> (carry, (value, accepted,
    gnorm)) advances num_steps iterations in one dispatch.  Counted
    objective evaluations == iterations, the same unit the reference logs.

    ``aux_fn`` (optional): evaluated on the final evaluated point
    (carry["x_prev"]) inside the same device program and appended to the
    per-dispatch outputs — used to surface the fused loss's capacity
    overflow flag without a separate host round trip.
    """

    value_and_grad = jax.value_and_grad(loss_fn)
    M = memory_size

    @jax.jit
    def init_fn(x0):
        x0 = jnp.asarray(x0)
        n = x0.shape[0]
        v0, g0 = value_and_grad(x0)
        return dict(
            x=x0, v=v0, g=g0,
            x_prev=x0, v_prev=v0, g_prev=g0,
            first=jnp.asarray(True),
            eta=jnp.asarray(1.0, x0.dtype),
            S=jnp.zeros((M, n), x0.dtype),
            Ymem=jnp.zeros((M, n), x0.dtype),
            rho=jnp.zeros((M,), x0.dtype),
            valid=jnp.zeros((M,), bool),
            head=jnp.asarray(0, jnp.int32),
        )

    def _two_loop(g, S, Ymem, rho, valid, head):
        # standard two-loop recursion over the circular memory
        idxs = (head - 1 - jnp.arange(M)) % M  # newest-first

        def bwd(q, i):
            use = valid[i]
            alpha = jnp.where(use, rho[i] * jnp.dot(S[i], q, precision=_HIGHEST), 0.0)
            q = q - alpha * Ymem[i] * use
            return q, alpha

        q, alphas = jax.lax.scan(bwd, g, idxs)
        # initial Hessian scaling gamma = s.y / y.y of the newest pair
        newest = (head - 1) % M
        sy = jnp.dot(S[newest], Ymem[newest], precision=_HIGHEST)
        yy = jnp.dot(Ymem[newest], Ymem[newest], precision=_HIGHEST)
        gamma = jnp.where(valid[newest] & (yy > 0), sy / yy, 1.0)
        r = gamma * q

        # iterate oldest-first = reverse of idxs
        def fwd2(carry, k):
            r = carry
            i = idxs[M - 1 - k]
            use = valid[i]
            beta = jnp.where(use, rho[i] * jnp.dot(Ymem[i], r, precision=_HIGHEST), 0.0)
            alpha = alphas[M - 1 - k]
            r = r + jnp.where(use, alpha - beta, 0.0) * S[i]
            return r, None

        r, _ = jax.lax.scan(fwd2, r, jnp.arange(M))
        return -r  # descent direction

    @jax.jit
    def run_fn(carry):
        def step(carry, _):
            c = dict(carry)
            v_new, g_new = value_and_grad(c["x"])
            # retrospective Armijo vs the departure point, with nonmonotone
            # slack at the dtype's resolution of the objective: in f32 at
            # |v| ~ 1e6+ the roundoff noise exceeds real late-stage
            # improvements, and a strict test spirals into rejections
            # slack reflects the objective's COMPUTE precision (f32 block
            # factorizations), not the accumulator dtype: per-block roundoff
            # roughness persists even when the scalar tails sum in f64
            eps = jnp.finfo(jnp.float32).eps
            slack = 8.0 * eps * jnp.abs(c["v_prev"])
            expected = c1 * jnp.abs(
                jnp.dot(c["g_prev"], c["x"] - c["x_prev"], precision=_HIGHEST)
            )
            ok = c["first"] | (v_new <= c["v_prev"] - expected) | (
                v_new <= c["v_prev"] + slack
            )

            # on accept: fold (s, y) into memory if curvature is positive
            s = c["x"] - c["x_prev"]
            y = g_new - c["g_prev"]
            sy = jnp.dot(s, y, precision=_HIGHEST)
            store = ok & (~c["first"]) & (sy > 1e-10)
            h = c["head"] % M
            S = jnp.where(store, c["S"].at[h].set(s), c["S"])
            Ymem = jnp.where(store, c["Ymem"].at[h].set(y), c["Ymem"])
            rho = jnp.where(store, c["rho"].at[h].set(1.0 / jnp.where(sy > 1e-10, sy, 1.0)), c["rho"])
            valid = jnp.where(store, c["valid"].at[h].set(True), c["valid"])
            head = jnp.where(store, c["head"] + 1, c["head"])

            # effective state: accepted -> new point; rejected -> revert
            x_eff = jnp.where(ok, c["x"], c["x_prev"])
            v_eff = jnp.where(ok, v_new, c["v_prev"])
            g_eff = jnp.where(ok, g_new, c["g_prev"])
            eta = jnp.where(ok, jnp.minimum(c["eta"] * eta_grow, 1.0), c["eta"] * eta_shrink)

            d = _two_loop(g_eff, S, Ymem, rho, valid, head)
            # first-iteration safeguard: gradient-norm-scaled steepest descent
            gn = jnp.linalg.norm(g_eff)
            d = jnp.where(
                jnp.any(valid), d, -g_eff / jnp.maximum(gn, 1.0)
            )
            x_next = x_eff + eta * d

            out = dict(
                x=x_next, v=v_eff, g=g_eff,
                x_prev=x_eff, v_prev=v_eff, g_prev=g_eff,
                first=jnp.asarray(False),
                eta=eta, S=S, Ymem=Ymem, rho=rho, valid=valid, head=head,
            )
            return out, (v_eff, ok, gn)

        carry, traj = jax.lax.scan(step, carry, None, length=num_steps)
        if aux_fn is not None:
            # check the last evaluated point AND the pending proposal (the
            # first point the next dispatch will evaluate).  A non-finite
            # point is masked out: NaN coordinates route every point into
            # one block (NaN comparisons are false), which would raise a
            # spurious overflow — a permanent capacity grow + cold
            # recompile — for a replica the driver is about to
            # sanitize/abort anyway.
            def masked(pt):
                return aux_fn(pt) & jnp.isfinite(pt).all()

            return carry, traj + (masked(carry["x_prev"]) | masked(carry["x"]),)
        return carry, traj

    return init_fn, run_fn


def make_multistart_runner(loss_fn, num_steps: int, **kwargs):
    """Batched multi-start scan-L-BFGS: R independent optimizations of the
    same loss from different starting points, vmapped into one device
    program.

    This turns the reference's fleet-of-processes parallelism
    (``gprfopt_analyze.py:352-387``) into one-dispatch batch parallelism
    for the multimodal GP-LVM landscape; no reference counterpart.  The
    replicas multiply the batch of every factorization, so on one card the
    win is dispatch amortization + best-of-R model quality; under a mesh
    the replica x block batch shards across devices like any other batch
    dim.

    Returns (init_fn, run_fn): init_fn takes x0s [R, n]; run_fn advances
    every replica num_steps iterations per dispatch (trajectories match
    running each start alone up to vmap reduction reassociation;
    per-replica optimizer state is fully independent).
    """
    init_fn, run_fn = make_scan_lbfgs_runner(loss_fn, num_steps, **kwargs)
    return jax.jit(jax.vmap(init_fn)), jax.jit(jax.vmap(run_fn))


@jax.jit
def _replica_bad_mask(x, v):
    """[R] device-side health mask: True where a replica's proposal or value
    went non-finite.  Computed on device so the per-dispatch host cost is a
    one-boolean-per-replica fetch instead of pulling the whole carry
    (S/Ymem alone are R x memory x n — ~10 MB at the flagship R=4) every
    dispatch."""
    return jnp.logical_not(
        jnp.isfinite(x).all(axis=1) & jnp.isfinite(v)
    )


def _sanitize_replicas(carry, bad=None):
    """Restart any replica whose state went non-finite instead of aborting
    the whole run: the replica resumes from its last evaluated point
    (x_prev) — or a clone of the current best replica if that too is dead —
    with cleared curvature memory, a conservative step scale, and v = +inf
    so it cannot be selected as the winner before its next evaluation.
    Raises only if every replica is unrecoverable.  Returns
    (carry, n_restarted).  ``bad`` is the (host) _replica_bad_mask; when
    omitted it is computed here."""
    if bad is None:
        bad = np.asarray(_replica_bad_mask(carry["x"], carry["v"]))
    if not bad.any():
        return carry, 0
    host = {k: np.array(v) for k, v in carry.items()}
    finite_v = np.isfinite(host["v"])
    prev_ok = np.isfinite(host["x_prev"]).all(axis=1)
    vs = np.where(prev_ok & finite_v, host["v"], np.inf)
    donor = int(np.argmin(vs))
    if not np.isfinite(vs[donor]):
        raise FloatingPointError("every replica diverged to non-finite state")
    M = host["S"].shape[1]
    for r in np.where(bad)[0]:
        src = host["x_prev"][r] if prev_ok[r] else host["x_prev"][donor]
        host["x"][r] = src
        host["x_prev"][r] = src
        host["g"][r] = 0.0
        host["g_prev"][r] = 0.0
        host["v"][r] = np.inf
        host["v_prev"][r] = np.inf
        host["first"][r] = True
        host["eta"][r] = 0.25
        host["S"][r] = 0.0
        host["Ymem"][r] = 0.0
        host["rho"][r] = 0.0
        host["valid"][r] = False
        host["head"][r] = 0
    return {k: jnp.asarray(v) for k, v in host.items()}, int(bad.sum())


def _fc_from_tail(fused, tail, ntheta):
    """Decode the host-side cov matrix from just the packed-cov tail of
    theta, via the evaluator's own ``unpack_host`` on a zero-padded dummy
    vector (the X segment does not influence FC).  Lets the drivers keep
    the covs.txt trajectory dense without fetching the n-sized parameter
    vector every dispatch."""
    full = np.zeros(ntheta, dtype=np.float64)
    full[ntheta - tail.size:] = tail
    return fused.unpack_host(full)[1]


def _check_capacity_all(fused, thetas):
    """True iff the current padded capacity holds every replica; one
    batched call when the evaluator provides it."""
    batch = getattr(fused, "check_capacity_batch", None)
    if batch is not None:
        return bool(batch(thetas))
    return all(fused.check_capacity(t) for t in thetas)


def _run_multistart(d, fused, theta0s, dtype, unpack_fn, write_covs,
                    maxsec, max_iters, steps_per_dispatch, ftol,
                    ckpt_every_sec: float = 10.0, stall_patience: int = 4):
    """Shared multi-start loop: R vmapped replicas, per-replica stall
    tracking (the run ends only when NO replica is still improving),
    divergence-tolerant restarts, and the standard file protocol written
    for the currently-best replica.  The checkpointed/returned point is
    the last EVALUATED point of the winner (carry["x_prev"], whose value
    is carry["v"]) — carry["x"] is the next, never-evaluated proposal.

    Per-dispatch host traffic is kept to small arrays (the [R, steps]
    value matrix, the replica health mask, the overflow flag): the [R, n]
    parameter fetch and the step/cov checkpoint ride a wall-clock cadence
    (``ckpt_every_sec``, plus always on the final dispatch) — fetching
    them every dispatch would make host transfer, not compute, the loop's
    cost."""
    theta0s = np.asarray(theta0s, dtype=np.float64)
    R = theta0s.shape[0]
    ntheta = theta0s.shape[1]
    make_aux = getattr(fused, "overflow_fn", None)
    aux_fn = make_aux() if make_aux is not None else None
    init_fn, run_fn = make_multistart_runner(
        fused.loss_fn(), steps_per_dispatch, aux_fn=aux_fn
    )
    carry = init_fn(jnp.asarray(theta0s, dtype=dtype))
    f_log = open(os.path.join(d, "log.txt"), "w")
    f_ms = open(os.path.join(d, "multistart.txt"), "w")
    ncov = getattr(fused, "ncov", 0) if write_covs else 0
    covf = open(os.path.join(d, "covs.txt"), "w") if ncov else None
    t0 = time.time()
    it = 0
    prev_best = np.full((R,), np.inf)
    stall = 0
    last_ckpt = -np.inf

    def checkpoint(it_base):
        thetas = np.asarray(carry["x_prev"], dtype=np.float64)
        cur_v = np.asarray(carry["v"])
        best_r = int(np.argmin(cur_v))
        X, FC = unpack_fn(thetas[best_r])
        save_step(d, it_base + steps_per_dispatch - 1, X=X, FC=FC)
        return thetas

    try:
        while it < max_iters and time.time() - t0 < maxsec:
            carry, outs = run_fn(carry)
            values = outs[0]
            vals = np.asarray(values)  # [R, steps] nll
            bad = np.asarray(_replica_bad_mask(carry["x"], carry["v"]))
            carry, n_restarted = _sanitize_replicas(carry, bad)
            if n_restarted:
                print("multistart: restarted %d diverged replica(s)" % n_restarted)
            # capacity: the in-program overflow flag (aux_fn) replaces the
            # per-dispatch host round trip when the evaluator provides it.
            # Diverged replicas are excluded — they were just reset to their
            # last finite point, whose capacity is re-checked next dispatch.
            overflowed = (
                bool((np.asarray(outs[3]) & ~bad).any())
                if aux_fn is not None
                else not _check_capacity_all(
                    fused, np.asarray(carry["x_prev"], dtype=np.float64)
                )
            )
            if overflowed:
                thetas = np.asarray(carry["x_prev"], dtype=np.float64)
                fused.grow_capacity()
                aux_fn = make_aux() if make_aux is not None else None
                init_fn, run_fn = make_multistart_runner(
                    fused.loss_fn(), steps_per_dispatch, aux_fn=aux_fn
                )
                fresh = init_fn(jnp.asarray(thetas, dtype=dtype))
                # keep each replica's curvature memory and adapted step
                # scale: the pairs were measured under a loss that differed
                # only by the few dropped points, still valid curvature
                carry = {
                    **fresh,
                    **{k: carry[k] for k in ("S", "Ymem", "rho", "valid",
                                             "head", "eta")},
                }
            now = time.time() - t0
            cur_v = np.asarray(carry["v"])
            best_r = int(np.argmin(cur_v))
            for k in range(vals.shape[1]):
                f_ms.write(
                    "%d %.2f %s\n"
                    % (it + k, now, " ".join("%.2f" % (-v) for v in vals[:, k]))
                )
                f_log.write("%d %.2f %.2f\n" % (it + k, now, float(-vals[best_r, k])))
            f_ms.flush()
            f_log.flush()
            # dense covs.txt trajectory (matching the single-start theta
            # driver) from just the winner's ncov-sized theta tail
            if covf is not None:
                tail = np.asarray(
                    carry["x_prev"][best_r, ntheta - ncov:], dtype=np.float64
                )
                FC = _fc_from_tail(fused, tail, ntheta)
                covf.write(
                    "%d %s\n" % (it + steps_per_dispatch - 1, FC)
                )
                covf.flush()
            if now - last_ckpt >= ckpt_every_sec:
                checkpoint(it)
                last_ckpt = now
            it += steps_per_dispatch
            # per-replica progress: only stop when no replica improves.
            # A diverged replica's vals column is NaN for the dispatch in
            # which it blew up; mask to +inf so the NaN can't poison
            # prev_best permanently (the replica was sanitized+restarted
            # above and must be able to register improvement again)
            vals_f = np.where(np.isfinite(vals), vals, np.inf)
            best_per = np.minimum(prev_best, vals_f.min(axis=1))
            improved = prev_best - best_per >= ftol * (np.abs(prev_best) + 1e-12)
            if not improved.any():
                stall += 1
                if stall >= stall_patience:
                    break
            else:
                stall = 0
            prev_best = best_per
        if it:
            # the analyzer keys its final row off the last logged step's
            # checkpoint — always write it even off-cadence
            checkpoint(it - steps_per_dispatch)
    finally:
        f_log.write("optimization finished after %.fs\n" % (time.time() - t0))
        f_log.close()
        f_ms.close()
        if covf is not None:
            covf.close()
        with open(os.path.join(d, "finished"), "w") as f:
            f.write("")
    final_v = np.asarray(carry["v"])
    best_r = int(np.argmin(final_v))
    best_theta = np.asarray(carry["x_prev"], dtype=np.float64)[best_r]
    return best_theta, float(final_v[best_r]), final_v


def do_optimization_multistart(
    d,
    fused,
    X0s,
    maxsec: float = 3600,
    max_iters: int = 400,
    steps_per_dispatch: int = 20,
    ftol: float = 1e-6,
    stall_patience: int = 4,
):
    """Multi-start driver over a task=x fused loss: optimize all R starts
    on device, log the per-replica objective matrix (``multistart.txt``:
    one row per iteration, one column per replica), and write the standard
    file protocol for the winning replica so downstream analysis tooling
    is unchanged.  Returns (best_x, best_v, final_values [R])."""
    X0s = np.asarray(X0s, dtype=np.float64)
    shape = X0s.shape[1:]
    return _run_multistart(
        d, fused, X0s.reshape(X0s.shape[0], -1), fused.Y.dtype,
        lambda t: (t.reshape(shape), None), False,
        maxsec, max_iters, steps_per_dispatch, ftol,
        stall_patience=stall_patience,
    )


def do_optimization_multistart_theta(
    d,
    fused,
    theta0s,
    maxsec: float = 3600,
    max_iters: int = 600,
    steps_per_dispatch: int = 20,
    ftol: float = 1e-6,
    stall_patience: int = 4,
):
    """Multi-start driver over a theta-packed fused evaluator (synthetic
    cov/xcov or seismic): all R replicas advance in one vmapped device
    program; the winner's X/cov trajectory is written through the standard
    file protocol (log.txt / step checkpoints / covs.txt), the per-replica
    objective matrix to ``multistart.txt``.  Returns
    (best_theta, best_v, final_values [R])."""
    return _run_multistart(
        d, fused, theta0s, fused.dtype, fused.unpack_host, True,
        maxsec, max_iters, steps_per_dispatch, ftol,
        stall_patience=stall_patience,
    )


def make_lbfgs_runner(loss_fn, num_steps: int, memory_size: int = 10,
                      max_linesearch_steps: int = 25):
    """(init_fn, run_fn): run_fn(x, state) advances ``num_steps`` L-BFGS
    iterations in one jitted call.

    Returns per-iteration diagnostics: objective value, line-search eval
    count, and gradient norm.
    """
    opt = optax.lbfgs(
        memory_size=memory_size,
        linesearch=optax.scale_by_zoom_linesearch(
            max_linesearch_steps=max_linesearch_steps
        ),
    )
    value_and_grad = optax.value_and_grad_from_state(loss_fn)

    def init_fn(x0):
        return opt.init(x0)

    @jax.jit
    def run_fn(x, state):
        def step(carry, _):
            x, state = carry
            value, grad = value_and_grad(x, state=state)
            updates, state = opt.update(
                grad, state, x, value=value, grad=grad, value_fn=loss_fn
            )
            x = optax.apply_updates(x, updates)
            ls_info = state[2].info
            return (x, state), (
                value,
                ls_info.num_linesearch_steps,
                otu.tree_norm(grad),
            )

        (x, state), traj = jax.lax.scan(step, (x, state), None, length=num_steps)
        return x, state, traj

    return init_fn, run_fn


def _truncate_log_rows(path, it0):
    """Drop rows with step index >= ``it0`` (and any trailer lines) from an
    append-mode log so a resumed run re-appends a monotone trajectory.

    Optimizer-state snapshots ride a wall-clock checkpoint cadence while
    log.txt/covs.txt rows are written every dispatch, so after a crash the
    saved state can lag the logs by up to ``ckpt_every_sec``; the resumed
    run re-executes those iterations and would otherwise duplicate their
    step indices in the log files downstream parsers read."""
    if not os.path.exists(path):
        return
    keep = []
    with open(path) as f:
        for line in f:
            parts = line.split(None, 1)
            try:
                step = int(parts[0])
            except (ValueError, IndexError):
                continue
            if step < it0:
                keep.append(line)
    with open(path, "w") as f:
        f.writelines(keep)


def save_optimizer_state(d, carry, it: int):
    """Checkpoint the full scan-L-BFGS carry (point, gradient, curvature
    memory) so a run resumes mid-optimization with identical trajectory —
    the resume analog of the reference's --init_x npy loading
    (``run_seismic.py:322-323``) but including optimizer memory."""
    flat = {k: np.asarray(v) for k, v in carry.items()}
    flat["__iter__"] = np.asarray(it)
    np.savez(os.path.join(d, "optimizer_state.npz"), **flat)


def load_optimizer_state(d):
    """(carry, it) from a saved optimizer checkpoint, or (None, 0)."""
    path = os.path.join(d, "optimizer_state.npz")
    if not os.path.exists(path):
        return None, 0
    z = np.load(path)
    it = int(z["__iter__"])
    carry = {k: jnp.asarray(z[k]) for k in z.files if k != "__iter__"}
    return carry, it


def do_optimization_fused(
    d,
    fused,
    X0,
    maxsec: float = 3600,
    max_iters: int = 400,
    steps_per_dispatch: int = 20,
    ftol: float = 1e-6,
    resume: bool = False,
    ckpt_every_sec: float = 10.0,
    stall_patience: int = 4,
):
    """Optimization driver over a :class:`~gprf_tpu.model.fused.FusedGridGPRF`
    loss with the reference file protocol (log.txt rows per L-BFGS
    iteration, X checkpoints, ``finished`` marker) plus full
    optimizer-state checkpointing for resume.

    X and optimizer-state checkpoints ride a wall-clock cadence
    (``ckpt_every_sec``, plus always on the final dispatch): the optimizer
    state alone is ~2.4 MB at the flagship (S/Ymem are memory x n), and
    fetching it every dispatch would put a host transfer on the critical
    path of every dispatch.  Divergence is detected from the
    per-step objective values (already fetched; NaN X implies NaN loss).

    Returns the final flat X.
    """
    make_aux = getattr(fused, "overflow_fn", None)
    aux_fn = make_aux() if make_aux is not None else None
    init_fn, run_fn = make_scan_lbfgs_runner(
        fused.loss_fn(), steps_per_dispatch, aux_fn=aux_fn
    )

    it = 0
    carry = None
    if resume:
        carry, it = load_optimizer_state(d)
    if carry is None:
        carry = init_fn(jnp.asarray(np.asarray(X0).reshape(-1), dtype=fused.Y.dtype))
        it = 0
    if resume and it:
        # the state snapshot can lag the per-dispatch log rows by up to
        # ckpt_every_sec; drop rows the resumed run will re-execute
        _truncate_log_rows(os.path.join(d, "log.txt"), it)
    f_log = open(os.path.join(d, "log.txt"), "a" if (resume and it) else "w")
    t0 = time.time()
    prev_best = np.inf
    stall = 0
    last_ckpt = -np.inf
    x_shape = np.asarray(X0).shape

    def checkpoint(it_base):
        x_host = np.asarray(carry["x"])
        if not np.all(np.isfinite(x_host)):
            raise FloatingPointError("optimizer diverged to non-finite X")
        # checkpoint index = last logged row of this dispatch, so the
        # analyzer finds an X for the final step
        save_step(d, it_base + steps_per_dispatch - 1, X=x_host.reshape(x_shape))
        save_optimizer_state(d, carry, it_base + steps_per_dispatch)
        return x_host

    try:
        while it < max_iters and time.time() - t0 < maxsec:
            carry, outs = run_fn(carry)
            values = -np.asarray(outs[0])  # stored as nll; log as ll below
            if not np.all(np.isfinite(values)):
                raise FloatingPointError("optimizer diverged to non-finite objective")
            overflowed = (
                bool(np.asarray(outs[3]))
                if aux_fn is not None
                else not fused.check_capacity(np.asarray(carry["x"]))
            )
            if overflowed:
                # a block outgrew the padded slot count: grow, recompile the
                # loss at the new capacity, and continue from the current
                # point keeping the curvature memory (the dropped-point loss
                # differed negligibly; membership drift is rare and slow, so
                # this is a cold recompile, not a hot-loop cost)
                x_host = np.asarray(carry["x"])
                fused.grow_capacity()
                aux_fn = make_aux() if make_aux is not None else None
                init_fn, run_fn = make_scan_lbfgs_runner(
                    fused.loss_fn(), steps_per_dispatch, aux_fn=aux_fn
                )
                fresh = init_fn(jnp.asarray(x_host, dtype=fused.Y.dtype))
                carry = {
                    **fresh,
                    **{k: carry[k] for k in ("S", "Ymem", "rho", "valid",
                                             "head", "eta")},
                }
            now = time.time() - t0
            if now - last_ckpt >= ckpt_every_sec:
                checkpoint(it)
                last_ckpt = now
            for k, v in enumerate(values):
                # positive objective rows like the reference log (ll)
                f_log.write("%d %.2f %.2f\n" % (it + k, now, float(v)))
            f_log.flush()
            it += steps_per_dispatch
            best = float((-values).min())
            if prev_best - best < ftol * (abs(prev_best) + 1e-12):
                stall += 1  # noise-tolerant: require repeated stalls
                if stall >= stall_patience:
                    break
            else:
                stall = 0
            prev_best = min(prev_best, best)
        if it:
            checkpoint(it - steps_per_dispatch)
    finally:
        f_log.write("optimization finished after %.fs\n" % (time.time() - t0))
        f_log.close()
        with open(os.path.join(d, "finished"), "w") as f:
            f.write("")
    return np.asarray(carry["x"])


def do_optimization_fused_theta(
    d,
    fused,
    theta0,
    maxsec: float = 3600,
    max_iters: int = 600,
    steps_per_dispatch: int = 20,
    ftol: float = 1e-6,
    resume: bool = False,
    ckpt_every_sec: float = 10.0,
    stall_patience: int = 4,
):
    """Device-loop driver over any theta-packed fused evaluator (seismic
    :class:`~gprf_tpu.model.fused_seismic.FusedSeismicGPRF` or synthetic
    :class:`~gprf_tpu.model.fused.FusedSyntheticGPRF`): the reference file
    protocol (log.txt, step X/cov checkpoints via the theta unpacking,
    covs.txt for hyperparameter trajectories, finished marker) around the
    scan-L-BFGS loop.  The per-dispatch covs.txt row keeps the
    hyperparameter trajectory dense; the .npy step checkpoint and the
    (memory x n) optimizer-state snapshot ride the ``ckpt_every_sec``
    cadence (plus always on the final dispatch) — see
    :func:`do_optimization_fused`."""
    make_aux = getattr(fused, "overflow_fn", None)
    aux_fn = make_aux() if make_aux is not None else None
    init_fn, run_fn = make_scan_lbfgs_runner(
        fused.loss_fn(), steps_per_dispatch, aux_fn=aux_fn
    )
    ncov = getattr(fused, "ncov", 0)
    ntheta = int(np.asarray(theta0).size)

    it = 0
    carry = None
    if resume:
        carry, it = load_optimizer_state(d)
    if carry is None:
        carry = init_fn(jnp.asarray(np.asarray(theta0), dtype=fused.dtype))
        it = 0
    if resume and it:
        _truncate_log_rows(os.path.join(d, "log.txt"), it)
        _truncate_log_rows(os.path.join(d, "covs.txt"), it)
    f_log = open(os.path.join(d, "log.txt"), "a" if (resume and it) else "w")
    # no covs.txt for task=x theta evaluators (FC is None there; the file
    # protocol writes covs.txt only on cov-bearing tasks)
    covf = (
        open(os.path.join(d, "covs.txt"), "a" if (resume and it) else "w")
        if ncov
        else None
    )
    t0 = time.time()
    prev_best = np.inf
    stall = 0
    last_ckpt = -np.inf

    def checkpoint(it_base, theta_host):
        # mirror do_optimization_fused's guard: never persist a non-finite
        # step_*_X.npy (e.g. a NaN final-step proposal whose evaluated
        # values were still finite this dispatch) for analyze_run to consume
        if not np.all(np.isfinite(theta_host)):
            raise FloatingPointError("optimizer diverged to non-finite theta")
        X, FC = fused.unpack_host(theta_host)
        save_step(d, it_base + steps_per_dispatch - 1, X=X, FC=FC)
        save_optimizer_state(d, carry, it_base + steps_per_dispatch)
        return FC

    try:
        while it < max_iters and time.time() - t0 < maxsec:
            carry, outs = run_fn(carry)
            values = -np.asarray(outs[0])
            if not np.all(np.isfinite(values)):
                raise FloatingPointError("optimizer diverged to non-finite objective")
            # per-dispatch host traffic is kept small: the n-sized theta
            # fetch happens only when something needs it (checkpoint
            # cadence, capacity growth, legacy host capacity check) — see
            # _run_multistart
            theta_host = None

            def fetch():
                nonlocal theta_host
                if theta_host is None:
                    theta_host = np.asarray(carry["x"], dtype=np.float64)
                return theta_host

            overflowed = (
                bool(np.asarray(outs[3]))
                if aux_fn is not None
                else not fused.check_capacity(fetch())
            )
            if overflowed:
                fused.grow_capacity()
                aux_fn = make_aux() if make_aux is not None else None
                init_fn, run_fn = make_scan_lbfgs_runner(
                    fused.loss_fn(), steps_per_dispatch, aux_fn=aux_fn
                )
                fresh = init_fn(jnp.asarray(fetch(), dtype=fused.dtype))
                carry = {
                    **fresh,
                    **{k: carry[k] for k in ("S", "Ymem", "rho", "valid",
                                             "head", "eta")},
                }
            now = time.time() - t0
            step_idx = it + steps_per_dispatch - 1
            if now - last_ckpt >= ckpt_every_sec:
                checkpoint(it, fetch())
                last_ckpt = now
            for k, v in enumerate(values):
                f_log.write("%d %.2f %.2f\n" % (it + k, now, float(v)))
            f_log.flush()
            # the covs.txt hyperparameter row stays per-dispatch (it is the
            # trajectory record the convergence figures read), decoded from
            # just the ncov-sized tail of the last EVALUATED point (x_prev —
            # carry["x"] is the next, never-evaluated proposal) so the row
            # pairs with the logged objective, as in _run_multistart
            if covf is not None:
                tail = np.asarray(
                    carry["x_prev"][ntheta - ncov:], dtype=np.float64
                )
                covf.write(
                    "%d %s\n" % (step_idx, _fc_from_tail(fused, tail, ntheta))
                )
                covf.flush()
            it += steps_per_dispatch
            best = float((-values).min())
            if prev_best - best < ftol * (abs(prev_best) + 1e-12):
                stall += 1  # noise-tolerant: require repeated stalls
                if stall >= stall_patience:
                    break
            else:
                stall = 0
            prev_best = min(prev_best, best)
        if it:
            checkpoint(
                it - steps_per_dispatch,
                np.asarray(carry["x"], dtype=np.float64),
            )
    finally:
        f_log.write("optimization finished after %.fs\n" % (time.time() - t0))
        f_log.close()
        if covf is not None:
            covf.close()
        with open(os.path.join(d, "finished"), "w") as f:
            f.write("")
    return np.asarray(carry["x"])


def refine_f64(d, make_fused, x32, it0, iters: int = 60,
               steps_per_dispatch: int = 10, maxsec: float = 1800):
    """Float64 refinement phase: rebuild the fused loss at f64 and continue
    the optimization from the f32 solution.

    The f32 objective's roundoff floors late-stage convergence at large n.
    The tail runs on the default device.  ``make_fused(dtype)`` builds the
    fused evaluator at the requested dtype; checkpoints/log rows continue
    the main run's numbering from ``it0``.

    Works for every device task: ``x32`` is the flat optimization vector
    (bare X for task=x, the packed theta for cov/xcov/seismic) and
    checkpointing goes through ``fused.unpack_host`` so cov checkpoints and
    ``covs.txt`` rows continue for theta tasks (reference task dispatch:
    ``gprfopt.py:548-574``).

    Wide blocks (m > 512, e.g. the 80k/100-block config at m=872) are
    skipped by default, because f64 pair terms cost O(E·(2m)³) per
    evaluation; what that costs on the GPU is not measured yet.
    ``GPRF_REFINE_MAX_M`` raises the cap for runs that accept the cost;
    ``GPRF_REFINE_MAXSEC`` overrides the phase budget, and wide-m runs
    drop to 2 optimizer steps per dispatch so the budget is enforced at a
    usable cadence.
    """
    jax.config.update("jax_enable_x64", True)
    maxsec = float(os.environ.get("GPRF_REFINE_MAXSEC", maxsec))
    fused = make_fused(jnp.float64)
    max_m = int(os.environ.get("GPRF_REFINE_MAX_M", 512))
    if fused.m > max_m:
        # f64 pair terms at these widths cost O(E * (2m)^3) per evaluation;
        # the f64 tail accumulation in the f32 objective is the supported
        # mitigation at wide m.  GPRF_REFINE_MAX_M opts in anyway.
        print(
            "refine_f64: block width m=%d exceeds the cap %d; "
            "skipping the f64 phase (raise GPRF_REFINE_MAX_M to force)"
            % (fused.m, max_m)
        )
        return np.asarray(x32)
    if fused.m > 512:
        # check the wall-clock budget (and write checkpoints) every couple
        # of steps instead of every ten
        steps_per_dispatch = min(steps_per_dispatch, 2)
    dev = jax.devices()[0]
    print("refine_f64: running the f64 tail on %s" % (dev,))
    init_fn, run_fn = make_scan_lbfgs_runner(fused.loss_fn(), steps_per_dispatch)
    carry = init_fn(jax.device_put(np.asarray(x32, dtype=np.float64), dev))
    f_log = open(os.path.join(d, "log.txt"), "a")
    # opened lazily on the first cov row: a task=x run must not grow a
    # spurious empty covs.txt from its refinement tail
    covf = None
    t0 = time.time()
    it = it0
    prev_best = np.inf
    stall = 0
    try:
        while it < it0 + iters and time.time() - t0 < maxsec:
            carry, (values, accepted, gnorms) = run_fn(carry)
            values = -np.asarray(values)
            x_host = np.asarray(carry["x"])
            step_idx = it + steps_per_dispatch - 1
            X, FC = fused.unpack_host(x_host)
            save_step(d, step_idx, X=X, FC=FC)
            if FC is not None:
                if covf is None:
                    covf = open(os.path.join(d, "covs.txt"), "a")
                covf.write("%d %s\n" % (step_idx, FC))
                covf.flush()
            now = time.time() - t0
            for k, v in enumerate(values):
                f_log.write("%d %.2f %.2f\n" % (it + k, now, float(v)))
            f_log.flush()
            it += steps_per_dispatch
            best = float((-values).min())
            if prev_best - best < 1e-9 * (abs(prev_best) + 1e-12):
                stall += 1
                if stall >= 2:
                    break
            else:
                stall = 0
            prev_best = min(prev_best, best)
    finally:
        f_log.write("f64 refinement finished after %.fs\n" % (time.time() - t0))
        f_log.close()
        if covf is not None:
            covf.close()
    return np.asarray(carry["x"])
