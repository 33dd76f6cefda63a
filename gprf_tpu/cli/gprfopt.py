"""Synthetic experiment CLI.

Flag-for-flag rebuild of the reference ``gprfopt.py`` argparse driver
(``gprfopt.py:605-637``), experiment-dir naming (``build_run_name``,
``gprfopt.py:588-603`` — the directory name encodes the config and doubles
as the cache key), and ``do_run`` orchestration (``gprfopt.py:525-584``).
The GPy GPLVM baselines (``--gplvm_type sparse|bayesian|titsias|basic``) are served
by the native JAX sparse-GPLVM baseline in
:mod:`gprf_tpu.model.sgplvm` instead of GPy.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gprf_tpu.analysis.results import analyze_run
from gprf_tpu.data.sampled import exp_base_dir, sample_data
from gprf_tpu.optim.driver import do_optimization
from gprf_tpu.partition.grid import grid_centers
from gprf_tpu.utils.compile_cache import configure_compile_cache
from gprf_tpu.utils.io import mkdir_p


def do_run(
    d,
    lscale,
    n,
    ntrain,
    nblocks,
    yd,
    seed=0,
    method="l-bfgs-b",
    obs_std=None,
    local_dist=1.0,
    maxsec=3600,
    max_iters=None,
    task="x",
    analyze_only=False,
    analyze_full=False,
    init_seed=-1,
    parallel=False,
    noise_var=0.01,
    rpc_blocksize=-1,
    gplvm_type="gprf",
    num_inducing=-1,
    init_true=False,
    init_x="",
    engine="host",
    refine_iters=0,
    multistart=1,
    ftol=1e-6,
    stall_patience=4,
):
    if rpc_blocksize == -1:
        centers = grid_centers(nblocks)
        print("gprf with %d blocks" % len(centers))
    else:
        centers = None
        print("gprf with rpc blocksize %d" % rpc_blocksize)

    if obs_std is None:
        obs_std = lscale / 10

    data = sample_data(
        n=n,
        ntrain=ntrain,
        lscale=lscale,
        obs_std=obs_std,
        yd=yd,
        seed=seed,
        centers=centers,
        noise_var=noise_var,
        rpc_blocksize=rpc_blocksize,
    )
    gprf = data.build_gprf(local_dist=local_dist)

    # continuation workflow (the seismic CLI's --init_x applied before task
    # dispatch, run_seismic.py:180-182, extended to the synthetic driver):
    # warm-start X from a previous run's step_%05d_X.npy checkpoint — e.g.
    # init a Local-GP run from a GPRF solution to escape basin traps
    X_init = None
    if init_x:
        if task == "cov":
            raise ValueError("--init_x has no effect on task=cov (X is fixed at the true latents)")
        X_init = np.load(init_x)
        if X_init.shape != data.X_obs.shape:
            raise ValueError(
                "--init_x shape %s != expected %s"
                % (X_init.shape, data.X_obs.shape)
            )

    # task dispatch (reference gprfopt.py:548-574)
    if task == "x":
        if X_init is not None:
            X0 = X_init
        elif init_true:
            X0 = data.SX
            gprf.update_X(X0)
        else:
            X0 = data.X_obs
        C0 = None
    elif task == "cov":
        X0 = None
        gprf.update_X(data.SX)
        if init_seed >= 0:
            np.random.seed(init_seed)
            C0 = np.exp(np.random.randn(1, 4) - 1)
        else:
            C0 = np.array((0.01, 1.0, 0.05, 0.05)).reshape(1, -1)
    elif task == "xcov":
        X0 = X_init if X_init is not None else data.X_obs
        if init_seed >= 0:
            np.random.seed(init_seed)
            C0 = np.exp(np.random.randn(1, 1) - 1)
            X0 = X0 + np.random.randn(*X0.shape) * 0.005
        else:
            lscale0 = float(np.asarray(gprf.cov.dfn_params)[0])
            C0 = np.array((lscale0,)).reshape(1, 1)
    else:
        raise ValueError("unrecognized task " + task)

    if not analyze_only:
        if engine != "device" and multistart > 1:
            print("WARNING: --multistart applies to the device engine only; running single-start")
        if engine == "device":
            if gplvm_type != "gprf":
                raise ValueError(
                    "--engine=device serves GPRF runs; GPLVM baselines use the host engine"
                )
            from gprf_tpu.model.fused import FusedSyntheticGPRF
            from gprf_tpu.optim.device_lbfgs import (
                do_optimization_fused,
                do_optimization_fused_theta,
            )

            # x64 enables the f64 accumulation of the objective's scalar
            # tails (factorizations stay f32); see model/objective._schur_ll
            import jax
            import jax.numpy as jnp

            jax.config.update("jax_enable_x64", True)

            # the partition the host path built: grid centers or the RPC
            # split tree (replayed on device, median recompute per node)
            if rpc_blocksize == -1:
                part = dict(centers=np.asarray(centers))
            else:
                part = dict(rpc_tree=data.rpc_splits)
            edges = gprf.neighbors  # [] for local GPs (local_dist = 1.0)
            X_anchor = data.SX if task == "cov" else X0

            def make_fused(dtype=jnp.float32):
                return FusedSyntheticGPRF(
                    X_anchor, data.SY, edges, data.X_obs, data.obs_std,
                    gprf.cov, gprf.noise_var, task=task, C0=C0,
                    dtype=dtype, **part,
                )

            # per-task iteration defaults; an explicit --max_iters wins
            if max_iters is None:
                max_iters = 400 if task == "x" else 600

            fused = make_fused()
            if task == "x" and multistart > 1:
                # on-chip multi-start: replica 0 is the standard init, the
                # rest are prior-scale perturbations of it (the GP-LVM
                # landscape is multimodal; one dispatch advances all
                # replicas — per-iteration cost scales ~linearly with R on
                # a single chip, see make_multistart_runner)
                from gprf_tpu.optim.device_lbfgs import do_optimization_multistart

                ms_rng = np.random.default_rng(seed + 1000)
                X0s = np.stack(
                    [X0]
                    + [
                        X0 + ms_rng.standard_normal(X0.shape) * data.obs_std
                        for _ in range(multistart - 1)
                    ]
                )
                x_final, best_v, final_v = do_optimization_multistart(
                    d, fused, X0s, maxsec=maxsec, max_iters=max_iters,
                    ftol=ftol, stall_patience=stall_patience,
                )
                print(
                    "multistart: best replica %d of %d (final objectives %s)"
                    % (int(np.argmin(final_v)), multistart, final_v)
                )
                if refine_iters > 0:
                    from gprf_tpu.optim.device_lbfgs import refine_f64
                    from gprf_tpu.optim.driver import load_log

                    it0 = int(load_log(d)[0][-1]) + 1
                    refine_f64(d, make_fused, x_final, it0, iters=refine_iters)
            elif task == "x":
                x_final = do_optimization_fused(
                    d, fused, X0, maxsec=maxsec, max_iters=max_iters,
                    ftol=ftol, stall_patience=stall_patience,
                )
                if refine_iters > 0:
                    from gprf_tpu.optim.device_lbfgs import refine_f64
                    from gprf_tpu.optim.driver import load_log

                    it0 = int(load_log(d)[0][-1]) + 1
                    refine_f64(d, make_fused, x_final, it0, iters=refine_iters)
            else:
                theta0 = fused.theta0()
                if multistart > 1:
                    from gprf_tpu.optim.device_lbfgs import (
                        do_optimization_multistart_theta,
                    )

                    ms_rng = np.random.default_rng(seed + 1000)
                    theta0s = [theta0]
                    for _ in range(multistart - 1):
                        t = theta0.copy()
                        if task == "xcov":  # perturb the X segment at prior scale
                            nflat = X0.size
                            t[:nflat] += ms_rng.standard_normal(nflat) * data.obs_std
                        # log-cov segment: the reference's init randomization
                        # draws log-scale params from N(-1, 1) (gprfopt.py:563)
                        ncov = C0.size
                        t[len(t) - ncov:] += (
                            ms_rng.standard_normal(ncov)
                            * 0.3
                            * FusedSyntheticGPRF.COV_SCALE
                        )
                        theta0s.append(t)
                    theta_final, best_v, final_v = do_optimization_multistart_theta(
                        d, fused, np.stack(theta0s), maxsec=maxsec,
                        max_iters=max_iters, ftol=ftol,
                        stall_patience=stall_patience,
                    )
                    print(
                        "multistart: best replica %d of %d (final objectives %s)"
                        % (int(np.argmin(final_v)), multistart, final_v)
                    )
                else:
                    theta_final = do_optimization_fused_theta(
                        d, fused, theta0, maxsec=maxsec, max_iters=max_iters,
                        ftol=ftol, stall_patience=stall_patience,
                    )
                if refine_iters > 0:
                    # f64 tail for the theta tasks too (the packed vector
                    # carries X and/or log-scale cov params; unpack-based
                    # checkpointing in refine_f64 handles both)
                    from gprf_tpu.optim.device_lbfgs import refine_f64
                    from gprf_tpu.optim.driver import load_log

                    it0 = int(load_log(d)[0][-1]) + 1
                    refine_f64(d, make_fused, theta_final, it0, iters=refine_iters)
        elif gplvm_type != "gprf":
            from gprf_tpu.model.sgplvm import do_sgplvm

            do_sgplvm(
                d,
                X0,
                C0,
                data,
                method=method,
                maxsec=maxsec,
                gplvm_type=gplvm_type,
                num_inducing=num_inducing,
                max_iters=max_iters,
            )
        else:
            do_optimization(
                d, gprf, X0, C0, data, method=method, maxsec=maxsec, parallel=parallel
            )

    analyze_run(
        d, data, local_dist=local_dist, predict=analyze_full,
        X0=(data.SX if task == "cov" else X0),
    )


def build_run_name(args):
    """Self-describing experiment dir name (reference ``gprfopt.py:588-597``)."""
    try:
        vals = (
            args.ntrain, args.ntest, args.nblocks, args.lscale, args.obs_std,
            args.local_dist, args.yd, args.method, args.task, args.init_seed,
            args.noise_var, args.rpc_blocksize, args.seed, args.gplvm_type,
            args.num_inducing, args.init_true,
        )
    except AttributeError:
        defaults = {
            "yd": 50, "seed": 0, "local_dist": 0.05, "method": "l-bfgs-b",
            "task": "x", "init_seed": -1, "noise_var": 0.01, "rpc_blocksize": -1,
            "gplvm_type": "gprf", "num_inducing": -1, "init_true": False,
        }
        defaults.update(args)
        a = defaults
        vals = (
            a["ntrain"], a["ntest"], a["nblocks"], a["lscale"], a["obs_std"],
            a["local_dist"], a["yd"], a["method"], a["task"], a["init_seed"],
            a["noise_var"], a["rpc_blocksize"], a["seed"], a["gplvm_type"],
            a["num_inducing"], a["init_true"],
        )
    (ntrain, ntest, nblocks, lscale, obs_std, local_dist, yd, method, task,
     init_seed, noise_var, rpc_blocksize, seed, gplvm_type, num_inducing,
     init_true) = vals
    if obs_std is None:
        # same default the sampler applies (data/sampled.py): the run-dir
        # name must match whether the user passed the value or let it default
        obs_std = lscale / 10
    return "%d_%d_%s_%.6f_%.6f_%.4f_%d_%s_%s_%d_%s_s%s_%s%d" % (
        ntrain,
        ntrain + ntest,
        "%d" % nblocks if rpc_blocksize == -1 else "%06d" % rpc_blocksize,
        lscale,
        obs_std,
        local_dist,
        yd,
        method,
        task,
        -9999 if init_true else init_seed,
        "%.4f" % noise_var,
        "%d" % seed,
        gplvm_type,
        num_inducing,
    )


def exp_dir(args):
    name = build_run_name(args)
    # continuation runs get their own dir (keyed on the init checkpoint) so
    # they don't clobber the fresh run's cache — same scheme the seismic CLI
    # uses (run_seismic.py:218-228 analog)
    init_x = getattr(args, "init_x", "")
    if init_x:
        import hashlib

        name += "_i%s" % hashlib.md5(init_x.encode()).hexdigest()[:8]
    # runs on different prior-sampler draws (GPRF_SAMPLER, data/sampled.py)
    # are different data realizations: keep their artifacts separate
    from gprf_tpu.data.synthetic import sampler_suffix

    name += sampler_suffix(args.ntrain + args.ntest)
    # non-default Schur precision changes the computation, not the data:
    # keep its artifacts separate too
    prec = getattr(args, "schur_precision", "")
    if prec and prec != "highest":
        name += "_p%s" % prec
    d = os.path.join(exp_base_dir(), name)
    mkdir_p(d)
    return d


def build_parser():
    parser = argparse.ArgumentParser(description="gprf_opt")
    parser.add_argument("--ntrain", dest="ntrain", type=int, help="number of points to locate")
    parser.add_argument("--ntest", dest="ntest", type=int, default=500, help="sample additional test points to evaluate predictive accuracy")
    parser.add_argument("--nblocks", dest="nblocks", default=1, type=int, help="divide sampled points into a grid of this many blocks (mutually exclusive with rpc_blocksize)")
    parser.add_argument("--rpc_blocksize", dest="rpc_blocksize", default=-1, type=int, help="recursive projection clustering with this target blocksize (mutually exclusive with nblocks)")
    parser.add_argument("--lscale", dest="lscale", type=float, help="SE kernel lengthscale for the sampled functions")
    parser.add_argument("--obs_std", dest="obs_std", type=float, default=None, help="std of Gaussian noise corrupting the X locations")
    parser.add_argument("--local_dist", dest="local_dist", default=1.0, type=float, help="minimum kernel value to connect blocks in a GPRF (1.0 = local GPs)")
    parser.add_argument("--method", dest="method", default="l-bfgs-b", type=str, help="scipy.optimize method")
    parser.add_argument("--seed", dest="seed", default=0, type=int, help="seed for generating synthetic data")
    parser.add_argument("--yd", dest="yd", default=50, type=int, help="number of output dimensions to sample")
    parser.add_argument("--maxsec", dest="maxsec", default=3600, type=int, help="maximum seconds to run the optimization")
    parser.add_argument("--max_iters", dest="max_iters", default=None, type=int, help="device engine: max scan-L-BFGS iterations (default 400 for task=x, 600 for cov/xcov). With --gplvm_type baselines it instead switches scipy from the reference protocol (ftol 1e-6, maxiter 200) to a converged protocol: this total eval budget at ftol 1e-10 with L-BFGS-B restarts on line-search aborts")
    parser.add_argument("--task", dest="task", default="x", type=str, help="'x', 'cov', or 'xcov'")
    parser.add_argument("--analyze", dest="analyze", default=False, action="store_true", help="only analyze existing saved results")
    parser.add_argument("--analyze_full", dest="analyze_full", default=False, action="store_true", help="fuller analysis incl. predictive accuracy")
    parser.add_argument("--parallel", dest="parallel", default=False, action="store_true", help="accepted for reference parity; the device path always batches blocks")
    parser.add_argument("--init_seed", dest="init_seed", default=-1, type=int, help="if >=0, randomized init from this seed")
    parser.add_argument("--init_true", dest="init_true", default=False, action="store_true", help="initialize at true X locations")
    parser.add_argument("--init_x", dest="init_x", default="", type=str, help="initialize X locations from a .npy checkpoint (continuation runs; task=x)")
    parser.add_argument("--noise_var", dest="noise_var", default=0.01, type=float, help="variance of iid noise in synthetic Y")
    parser.add_argument("--gplvm_type", dest="gplvm_type", default="gprf", type=str, help="'gprf', or 'sparse'/'bayesian'/'basic' for the inducing-point GPLVM baseline")
    parser.add_argument("--num_inducing", dest="num_inducing", default=0, type=int, help="number of inducing points for sparse baselines")
    parser.add_argument("--engine", dest="engine", default="host", choices=["host", "device"], help="host: scipy L-BFGS-B per-eval dispatch (reference semantics); device: fully on-device scan-L-BFGS loop (fast path; task=x grid runs)")
    parser.add_argument("--refine_iters", dest="refine_iters", default=0, type=int, help="device engine: follow the f32 loop with this many float64 refinement iterations (breaks the f32 convergence floor at large n)")
    parser.add_argument("--ftol", dest="ftol", default=1e-6, type=float, help="device engine: relative per-dispatch improvement threshold for stall detection")
    parser.add_argument("--stall_patience", dest="stall_patience", default=4, type=int, help="device engine: consecutive stalled dispatches before stopping")
    parser.add_argument("--multistart", dest="multistart", default=1, type=int, help="device engine (all tasks): optimize this many on-chip replicas (replica 0 = standard init, others prior/log-scale perturbations) and keep the best final objective; ignored by the host engine")
    parser.add_argument("--schur_precision", dest="schur_precision", default="", choices=["", "highest", "high"], help="matmul precision of the forward Schur algebra: 'highest' (the default) keeps every f32 product in full f32; 'high' lets the compiler use a faster, less accurate f32 product, which can cost latent accuracy. Sets GPRF_SCHUR_PRECISION in a fresh process (the setting is read once at import)")
    return parser


def main(argv=None):
    configure_compile_cache()
    mkdir_p(exp_base_dir())
    args = build_parser().parse_args(argv)
    if args.schur_precision and (
        os.environ.get("GPRF_SCHUR_PRECISION", "highest") != args.schur_precision
    ):
        # precision toggles are read once at gprf_tpu import (the jit cache
        # is not keyed on env vars, so a mid-process flip could mix stale
        # compilations); re-exec with the env pinned so the whole process
        # traces at the requested precision
        import sys

        os.environ["GPRF_SCHUR_PRECISION"] = args.schur_precision
        os.execv(
            sys.executable,
            [sys.executable, "-m", "gprf_tpu.cli.gprfopt"]
            + (list(argv) if argv is not None else sys.argv[1:]),
        )
    d = exp_dir(args)
    print("experiment dir:", d)
    do_run(
        d=d,
        lscale=args.lscale,
        obs_std=args.obs_std,
        local_dist=args.local_dist,
        n=args.ntrain + args.ntest,
        ntrain=args.ntrain,
        nblocks=args.nblocks,
        yd=args.yd,
        method=args.method,
        rpc_blocksize=args.rpc_blocksize,
        seed=args.seed,
        maxsec=args.maxsec,
        max_iters=args.max_iters,
        analyze_only=args.analyze,
        analyze_full=args.analyze_full,
        task=args.task,
        init_seed=args.init_seed,
        noise_var=args.noise_var,
        parallel=args.parallel,
        gplvm_type=args.gplvm_type,
        num_inducing=args.num_inducing,
        init_true=args.init_true,
        init_x=args.init_x,
        engine=args.engine,
        refine_iters=args.refine_iters,
        multistart=args.multistart,
        ftol=args.ftol,
        stall_patience=args.stall_patience,
    )


if __name__ == "__main__":
    main()
