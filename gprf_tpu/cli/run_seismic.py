"""Seismic event-relocation CLI.

Flag-for-flag rebuild of the reference ``run_seismic.py`` main
(``run_seismic.py:309-419``): PD-tree partitioning with longitude wrap,
neighbor-list caching to ``.npy``, GPRF construction over the Matern-3/2
great-circle kernel, the seismic optimization driver (depth rescaling,
clamps, gradient clipping), and per-step location-error analysis against the
catalog ("true") locations.
"""

from __future__ import annotations

import argparse
import hashlib
import os

import numpy as np

from gprf_tpu.data.seismic import (
    COL_DEPTH,
    COL_LAT,
    COL_LON,
    load_data,
    mad,
    make_x_prior,
)
from gprf_tpu.model.gprf import GPRF
from gprf_tpu.optim.driver import do_optimization_seismic, load_log
from gprf_tpu.optim.priors import seismic_cov_prior
from gprf_tpu.partition.pdtree import pdtree_cluster
from gprf_tpu.utils.compile_cache import configure_compile_cache
from gprf_tpu.utils.io import mkdir_p, step_cov_path, step_x_path


def seismic_exp_dir(args):
    """Self-describing experiment dir (``run_seismic.py:218-228``)."""
    base_dir = os.environ.get(
        "SEISMIC_EXPERIMENTS",
        os.path.join(os.path.expanduser("~"), "seismic_experiments"),
    )
    init_str = "default"
    if args.init_cov or args.init_x:
        init_str = "_%s" % hashlib.md5(
            (args.init_cov + args.init_x).encode()
        ).hexdigest()[:8]
    run_name = "%d_%d_%.4f_%s_%s_%.0f_%.1f" % (
        args.npts,
        args.rpc_blocksize,
        args.threshold,
        init_str,
        args.task,
        args.synth_lscale,
        args.obs_std,
    )
    d = os.path.join(base_dir, run_name)
    mkdir_p(d)
    return d


def analyze_run_result(args, gprf, x_prior, X_true, cov_true, lscale_true,
                       X0=None):
    """Per-step mean/median km error vs catalog locations + true-X objective
    (``run_seismic.py:235-288``)."""
    d = seismic_exp_dir(args)
    steps, times, lls = load_log(d)
    rfname = os.path.join(d, "results.txt")
    results = open(rfname, "w")
    print("writing results to", rfname)

    # rows between checkpoints carry the last checkpointed state forward;
    # the pre-optimization fallback is the observed locations X0 (NEVER
    # X_true, which would report zero error for steps that never achieved
    # it)
    prev_X, prev_FC = None, None
    for i, step in enumerate(steps):
        try:
            X = np.load(step_x_path(d, step))
        except (IOError, OSError):
            X = prev_X if prev_X is not None else (
                X0 if X0 is not None else X_true
            )
        try:
            FC = np.load(step_cov_path(d, step))
        except (IOError, OSError):
            FC = prev_FC
        prev_X, prev_FC = X, FC
        c1 = FC[0, 2] / lscale_true if FC is not None else 1.0
        l1, l2 = mad(X_true, X)
        s = "%d %.2f %.2f %.8f %.8f %.8f" % (step, times[i], lls[i], c1, l1, l2)
        print(s)
        results.write(s + "\n")

    gprf.update_X(X_true)
    gprf.update_covs(cov_true)
    lltrue = gprf.llgrad(grad_X=False, grad_cov=False)[0]
    priortrue = x_prior(X_true)[0]
    s = "true X ll %.2f" % (lltrue + priortrue)
    print(s)
    results.write(s + "\n")
    results.close()


def build_parser():
    parser = argparse.ArgumentParser(description="seismic")
    parser.add_argument("--npts", dest="npts", default=-1, type=int, help="do inference on a subset of data, for debugging")
    parser.add_argument("--obs_std", dest="obs_std", default=-1, type=float, help="stddev for sampling observed X values")
    parser.add_argument("--threshold", dest="threshold", default=1.0, type=float, help="covariance threshold for adding a GPRF edge; 1.0 is local GPs, 0.6 approx one lengthscale")
    parser.add_argument("--synth_lscale", dest="synth_lscale", default=40.0, type=float, help="Matern lengthscale (km) for generating Y values")
    parser.add_argument("--seed", dest="seed", default=0, type=int, help="seed for sampling")
    parser.add_argument("--maxsec", dest="maxsec", default=3600, type=int, help="maximum seconds of inference")
    parser.add_argument("--sparse", dest="sparse", default=False, action="store_true", help="truncated-support sparse per-block linear algebra (native sparse Cholesky + selected inverse); NOT inducing-point sparsity (False)")
    parser.add_argument("--analyze", dest="analyze", default=False, action="store_true", help="only generate results from saved state")
    parser.add_argument("--rpc_blocksize", dest="rpc_blocksize", default=300, type=int, help="max points per PD-tree block")
    parser.add_argument("--init_cov", dest="init_cov", default="", type=str, help="initialize cov params from .npy")
    parser.add_argument("--init_x", dest="init_x", default="", type=str, help="initialize X locations from .npy")
    parser.add_argument("--task", dest="task", default="xcov", type=str, help="'x', 'cov', or 'xcov'")
    parser.add_argument("--parallel", dest="parallel", default=False, action="store_true", help="accepted for parity; the device path always batches")
    parser.add_argument("--data_dir", dest="data_dir", default=".", type=str, help="directory holding sorted_isc.npy / cached Y")
    parser.add_argument("--engine", dest="engine", default="host", choices=["host", "device"], help="host: scipy L-BFGS-B per-eval dispatch (reference semantics); device: fully on-device scan-L-BFGS loop")
    parser.add_argument("--multistart", dest="multistart", default=1, type=int, help="device engine: optimize this many on-chip replicas and keep the best final objective")
    parser.add_argument("--refine_iters", dest="refine_iters", default=0, type=int, help="device engine: continue this many float64 refinement iterations from the f32 solution")
    parser.add_argument("--max_iters", dest="max_iters", default=600, type=int, help="device engine: max scan-L-BFGS iterations")
    parser.add_argument("--ftol", dest="ftol", default=1e-6, type=float, help="device engine: relative per-dispatch improvement threshold for stall detection")
    parser.add_argument("--stall_patience", dest="stall_patience", default=4, type=int, help="device engine: consecutive stalled dispatches before stopping")
    return parser


def main(argv=None):
    configure_compile_cache()
    args = build_parser().parse_args(argv)
    d = seismic_exp_dir(args)
    print("experiment dir:", d)
    seed = args.seed
    threshold = args.threshold

    sorted_isc, SY, cov = load_data(args.synth_lscale, seed, data_dir=args.data_dir)

    np.random.seed(seed)
    cov_true = np.array(
        [0.1, float(np.asarray(cov.wfn_params)[0])]
        + list(np.asarray(cov.dfn_params))
    ).reshape((1, -1))
    if args.synth_lscale < 0:
        cov_true[0, 0] = 1.0
        cov_true[0, 1] = 0.1

    if args.npts > 0:
        npts = args.npts
        base = min(60000, max(len(SY) - npts, 0))  # reference uses base=60000
        sorted_isc = sorted_isc[base : base + npts, :]
        SY = SY[base : base + npts, :]
    else:
        npts = len(SY)

    X_true = sorted_isc[:, (COL_LON, COL_LAT, COL_DEPTH)]
    np.random.seed(seed)
    prior_std = args.obs_std * np.array([0.01, 0.01, 1.0])
    noise = np.random.randn(*X_true.shape) * prior_std
    means = X_true + noise
    X0 = means.copy()
    x_prior = make_x_prior(means, prior_std)

    n = X0.shape[0]
    cluster_idxs, reblock = pdtree_cluster(X0, blocksize=args.rpc_blocksize)

    neighbor_fname = os.path.join(
        args.data_dir,
        "neighbors_%d_%d_%.3f_%.3f.npy" % (n, args.rpc_blocksize, threshold, args.obs_std),
    )
    if threshold == 1.0:
        neighbors = []
    else:
        try:
            neighbors = np.load(neighbor_fname)
        except (IOError, OSError):
            neighbors = None

    C0 = cov_true.copy() if args.init_cov == "" else np.load(args.init_cov)
    if args.init_x != "":
        X0 = np.load(args.init_x)

    nv = cov_true[0, 0]
    gprf = GPRF(
        X0,
        SY,
        reblock,
        cov,
        nv,
        neighbor_threshold=threshold,
        block_idxs=cluster_idxs,
        neighbors=neighbors,
    )
    if neighbors is None:
        np.save(neighbor_fname, np.asarray(gprf.neighbors, dtype=np.int32).reshape(-1, 2))

    if args.task == "x":
        C0 = None
    elif args.task == "cov":
        X0 = None

    if not args.analyze:
        if args.engine == "device":
            from gprf_tpu.model.fused_seismic import FusedSeismicGPRF
            from gprf_tpu.optim.device_lbfgs import do_optimization_fused_theta
            from gprf_tpu.partition.pdtree import PDTree, wrap_lon

            X2 = means[:, :2].copy()
            X2[:, 0] = wrap_lon(X2[:, 0])
            tree = PDTree(X2, minsize=args.rpc_blocksize)

            def make_fused(dtype=None):
                return FusedSeismicGPRF(
                    means, SY, tree, gprf.neighbors, means, prior_std, cov,
                    nv, task=args.task, dtype=dtype,
                )

            fused = make_fused()
            theta0 = fused.theta0(X0 if X0 is not None else means, C0)
            if args.multistart > 1:
                from gprf_tpu.optim.device_lbfgs import (
                    do_optimization_multistart_theta,
                )

                # replicas perturb the (lon, lat, depth-scaled) segment at
                # the observation-prior scale and the log-cov tail mildly
                ms_rng = np.random.default_rng(args.seed + 1000)
                nx = means.size
                theta0s = [theta0]
                for _ in range(args.multistart - 1):
                    t = theta0.copy()
                    if args.task in ("x", "xcov"):
                        t[:nx] += ms_rng.standard_normal(nx) * 0.05
                    if len(t) > nx or args.task == "cov":
                        ncov = len(t) - (nx if args.task == "xcov" else 0)
                        if ncov > 0:
                            t[len(t) - ncov:] += ms_rng.standard_normal(ncov) * 0.3
                    theta0s.append(t)
                theta_final, best_v, final_v = do_optimization_multistart_theta(
                    d, fused, np.stack(theta0s), maxsec=args.maxsec,
                    max_iters=args.max_iters, ftol=args.ftol,
                    stall_patience=args.stall_patience,
                )
                print(
                    "multistart: best replica %d of %d (final objectives %s)"
                    % (int(np.argmin(final_v)), args.multistart, final_v)
                )
            else:
                theta_final = do_optimization_fused_theta(
                    d, fused, theta0, maxsec=args.maxsec,
                    max_iters=args.max_iters, ftol=args.ftol,
                    stall_patience=args.stall_patience,
                )
            if args.refine_iters > 0:
                from gprf_tpu.optim.device_lbfgs import refine_f64
                from gprf_tpu.optim.driver import load_log

                it0 = int(load_log(d)[0][-1]) + 1
                refine_f64(
                    d, make_fused, theta_final, it0, iters=args.refine_iters
                )
        else:
            do_optimization_seismic(
                d,
                gprf,
                X0,
                C0,
                seismic_cov_prior,
                x_prior,
                maxsec=args.maxsec,
                parallel=args.parallel,
                sparse=args.sparse,
            )

    if args.task in ("x", "xcov"):
        analyze_run_result(
            args, gprf, x_prior, X_true, cov_true, args.synth_lscale, X0=means
        )


if __name__ == "__main__":
    main()
