"""End-to-end smoke run of the GPRF fit on one NVIDIA GPU.

Drives the system's main path once, in this one process, through the same
entry points a user calls (``gprf_tpu.cli.gprfopt.main`` and
``gprf_tpu.cli.run_seismic.main``), at the reference deployments' full
widths, then checks the production f32 objective and gradients against the
float64 joint-form oracle on the card.  Phases:

  1. device check: JAX's default device must be a GPU (no fallback)
  2. flagship, device engine (n=10k, 100 grid blocks, dy=50, f64 tail)
  3. flagship, host engine (scipy L-BFGS-B, one device llgrad per eval)
  4. flagship multistart (4 replicas, device engine)
  5. seismic xcov, device engine (12k-event catalog, PD-tree blocks of 210)
  6. correctness: f32 Schur form vs the f64 oracle at m=136, m~192 and one
     width in (512, 1024]

Any failed phase ends the script with a non-zero code.  The last line of
standard output is one JSON object naming the device.  Times printed on the
way are smoke readings, not benchmark figures.

    python chip_smoke.py                # one card, every phase
    python chip_smoke.py --four-cards   # only the sharded path on 4 cards

Outputs (experiment dirs, data caches) go to ``smoke_out/`` in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "smoke_out")

FLAGSHIP_ARGS = [
    "--ntrain=10000", "--ntest=500", "--nblocks=100", "--lscale=0.06",
    "--obs_std=0.02", "--local_dist=0.1", "--yd=50", "--task=x",
]
# the reference's seismic GPRF deployment (BASELINE.md: blocksize 210,
# threshold 0.6, obs_std 20)
SEISMIC_ARGS = [
    "--engine=device", "--task=xcov", "--rpc_blocksize=210",
    "--threshold=0.6", "--obs_std=20",
]
# modules the main path must not need: the card's machine may lack them
OPTIONAL_MODULES = ("matplotlib", "sklearn", "torch", "triton", "pandas", "GPy")


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg) -> None:
    """An explicit check: unlike ``assert`` it also holds under ``python -O``."""
    if not cond:
        raise AssertionError(msg)


# ---- phase 1 -------------------------------------------------------------


def phase_device(n_cards: int = 1) -> dict:
    """Fail unless JAX's default device is a GPU; print what it is."""
    from gprf_tpu.utils.device import nvidia_smi_name_power, require_gpu

    info = require_gpu()
    if info["count"] < n_cards:
        raise RuntimeError(
            "needs %d GPUs, JAX sees %d" % (n_cards, info["count"])
        )
    say("device: platform=%s kind=%s count=%d"
        % (info["platform"], info["kind"], info["count"]))
    say(nvidia_smi_name_power())
    return info


def check_imports() -> None:
    """The CLIs' import graph stays inside the guaranteed packages."""
    import gprf_tpu.cli.gprfopt  # noqa: F401
    import gprf_tpu.cli.run_seismic  # noqa: F401

    loaded = [m for m in OPTIONAL_MODULES if m in sys.modules]
    check(not loaded, "main path imports optional modules: %s" % loaded)
    say("imports: the CLIs load none of %s" % (OPTIONAL_MODULES,))


# ---- shared checks -------------------------------------------------------


def _fresh_x64_off():
    """Each CLI call starts as a fresh process would: x64 off (the device
    engine turns it on itself)."""
    import jax

    jax.config.update("jax_enable_x64", False)


def check_log(d: str, label: str) -> np.ndarray:
    """log.txt values: all finite and the objective improves."""
    from gprf_tpu.optim.driver import load_log

    steps, times, lls = load_log(d)
    check(len(lls) >= 2, "%s: only %d log rows in %s" % (label, len(lls), d))
    check(np.all(np.isfinite(lls)), "%s: non-finite objective in log" % label)
    check(lls.max() > lls[0], (
        "%s: objective did not improve (%.3f -> best %.3f)"
        % (label, lls[0], lls.max())
    ))
    # the main phase's rows come before its closing line; a later phase
    # (the f64 tail) keeps its own clock.  The device engine stamps every
    # row of a dispatch with the time at its end, so the first dispatch's
    # rows carry its compile.
    with open(os.path.join(d, "log.txt")) as f:
        k = 0
        for line in f:
            if not line[:1].isdigit():
                break
            k += 1
    k = max(min(k, len(times)), 2)
    per_iter = (times[k - 1] - times[0]) / (k - 1)
    say("smoke reading, %s: %d log rows, ll %.2f -> %.2f (best %.2f), "
        "%.2f ms per iteration over the main phase's %d rows"
        % (label, len(lls), lls[0], lls[-1], lls.max(), per_iter * 1e3, k))
    return lls


def run_gprfopt(label: str, extra_args) -> str:
    """One gprfopt run in its own experiment base dir; returns the run dir."""
    from gprf_tpu.cli import gprfopt

    base = os.path.join(OUT, label)
    os.makedirs(base, exist_ok=True)
    shared = os.path.join(OUT, "synthetic_datasets")
    os.makedirs(shared, exist_ok=True)
    link = os.path.join(base, "synthetic_datasets")
    if not os.path.exists(link):
        os.symlink(shared, link)
    os.environ["GPRF_EXPERIMENTS"] = base
    argv = FLAGSHIP_ARGS + list(extra_args)
    _fresh_x64_off()
    t0 = time.time()
    gprfopt.main(argv)
    say("smoke reading, %s: CLI wall %.1f s (data, compile, fit, analysis)"
        % (label, time.time() - t0))
    return gprfopt.exp_dir(gprfopt.build_parser().parse_args(argv))


def flagship_args():
    from gprf_tpu.cli import gprfopt

    return gprfopt.build_parser().parse_args(FLAGSHIP_ARGS)


def flagship_data():
    """The flagship SampledData (from the cache the CLI runs wrote)."""
    from gprf_tpu.data.sampled import sample_data
    from gprf_tpu.partition.grid import grid_centers

    a = flagship_args()
    os.environ["GPRF_EXPERIMENTS"] = OUT
    return sample_data(
        n=a.ntrain + a.ntest, ntrain=a.ntrain, lscale=a.lscale,
        obs_std=a.obs_std, yd=a.yd, seed=a.seed,
        centers=grid_centers(a.nblocks), noise_var=a.noise_var,
    )


def check_latent_error(d: str, data, label: str, row: str = "final") -> None:
    """The mean latent error falls below its value at X_obs: at the run's
    final row, or at its best-objective row.  The host engine checkpoints
    every point scipy evaluates, line-search trials included, and a
    ``--maxsec`` cut can land on a trial; its answer is the best point."""
    from gprf_tpu.analysis.results import load_results

    rows = load_results(d)  # numeric rows, without the trueX oracle row
    r = rows[-1] if row == "final" else rows[int(np.argmax(rows[:, 2]))]
    at_obs = data.mean_distance(data.X_obs.flatten())
    say("%s: mean latent error %.6f at X_obs -> %.6f (%s row, step %d)"
        % (label, at_obs, r[4], row, int(r[0])))
    check(r[4] < at_obs, (
        "%s: latent error did not fall (%.6f >= %.6f)" % (label, r[4], at_obs)
    ))


# ---- phases 2-4 ----------------------------------------------------------


def phase_flagship_device() -> None:
    d = run_gprfopt("flagship_device", [
        "--engine=device", "--max_iters=50", "--refine_iters=10",
        "--maxsec=300",
    ])
    with open(os.path.join(d, "log.txt")) as f:
        check("f64 refinement finished" in f.read(), "the f64 tail did not run")
    check_log(d, "flagship device engine (+f64 tail)")
    check_latent_error(d, flagship_data(), "flagship device engine")


def phase_flagship_host() -> None:
    d = run_gprfopt("flagship_host", ["--engine=host", "--maxsec=30"])
    check_log(d, "flagship host engine")
    check_latent_error(d, flagship_data(), "flagship host engine", row="best")


def phase_multistart() -> None:
    d = run_gprfopt("flagship_multistart", [
        "--engine=device", "--multistart=4", "--max_iters=25",
        "--maxsec=300",
    ])
    check_log(d, "flagship multistart R=4")
    check_latent_error(d, flagship_data(), "flagship multistart R=4")


# ---- phase 5 -------------------------------------------------------------


def seismic_args():
    from gprf_tpu.cli import run_seismic

    return run_seismic.build_parser().parse_args(SEISMIC_ARGS)


def seismic_inputs(data_dir: str):
    """(X_true, means, SY, cov): the seismic CLI's inputs, rebuilt exactly
    as ``gprf_tpu.cli.run_seismic.main`` builds them."""
    from gprf_tpu.data.seismic import COL_DEPTH, COL_LAT, COL_LON, load_data

    a = seismic_args()
    sorted_isc, SY, cov = load_data(a.synth_lscale, a.seed, data_dir=data_dir)
    X_true = sorted_isc[:, (COL_LON, COL_LAT, COL_DEPTH)]
    np.random.seed(a.seed)
    prior_std = a.obs_std * np.array([0.01, 0.01, 1.0])
    means = X_true + np.random.randn(*X_true.shape) * prior_std
    return X_true, means, SY, cov


def phase_seismic() -> None:
    from gprf_tpu.cli import run_seismic
    from gprf_tpu.data.seismic import mad

    data_dir = os.path.join(OUT, "seismic_data")
    os.makedirs(data_dir, exist_ok=True)
    os.environ["SEISMIC_EXPERIMENTS"] = os.path.join(OUT, "seismic_experiments")
    argv = SEISMIC_ARGS + ["--max_iters=40", "--maxsec=300",
                           "--data_dir=" + data_dir]
    _fresh_x64_off()
    t0 = time.time()
    run_seismic.main(argv)
    say("smoke reading, seismic xcov: CLI wall %.1f s (data, compile, fit, "
        "analysis)" % (time.time() - t0))
    d = run_seismic.seismic_exp_dir(run_seismic.build_parser().parse_args(argv))
    check_log(d, "seismic xcov device engine")
    X_true, means, _, _ = seismic_inputs(data_dir)
    with open(os.path.join(d, "results.txt")) as f:
        rows = [ln.split() for ln in f if ln[:1].isdigit()]
    final_km = float(rows[-1][4])
    at_obs_km = mad(X_true, means)[0]
    say("seismic xcov: mean location error %.3f km at the observed "
        "locations -> %.3f km" % (at_obs_km, final_km))
    check(final_km < at_obs_km, "seismic location error did not fall")


# ---- phase 6 -------------------------------------------------------------


def wide_problem(n: int = 8000, nblocks: int = 9, dy: int = 50,
                 extent: float = 0.3, lscale: float = 0.021213, seed: int = 0):
    """A slice of the 80k/100-block deployment: n uniform points over an
    extent x extent square (the 80k density) in nblocks grid blocks, so the
    blocks are as wide as that deployment's (m ~ 900).  Y is iid: the
    comparison does not depend on Y's law."""
    from gprf_tpu.kernels.gpcov import GPCov
    from gprf_tpu.model.gprf import GPRF
    from gprf_tpu.partition.grid import Blocker, grid_centers

    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2)) * extent
    Y = rng.standard_normal((n, dy))
    b = Blocker(np.asarray(grid_centers(nblocks)) * extent)
    cov = GPCov.create([1.0], [lscale, lscale])
    return GPRF(X, Y, None, cov, 0.01, block_idxs=b.block_clusters(X),
                neighbors=b.neighbors(diag_connections=False))


def seismic_problem(means, SY, cov, blocksize: int, threshold: float,
                    noise_var: float = 0.1):
    """The seismic deployment's GPRF at the observed locations (the CLI's
    noise variance 0.1)."""
    from gprf_tpu.model.gprf import GPRF
    from gprf_tpu.partition.pdtree import pdtree_cluster

    blocks, _ = pdtree_cluster(means, blocksize=blocksize)
    return GPRF(means, SY, None, cov, noise_var, block_idxs=blocks,
                neighbor_threshold=threshold)


def correctness_phase(problems) -> list:
    """f32 Schur objective and gradients vs the f64 joint-form oracle on
    the default device (:func:`gprf_tpu.model.parity.schur_parity`), for
    each (label, GPRF).  Raises AssertionError listing every failure."""
    from gprf_tpu.model import parity

    results, failures = [], []
    for label, g in problems:
        t0 = time.time()
        r = parity.schur_parity(g)
        cpu = r["cpu"]
        say("parity %s (m=%d, B=%d, E=%d): rel err vs f64 oracle: ll %.3e "
            "gradX %.3e gradcov %.3e | same f32 on the CPU: ll %.3e gradX "
            "%.3e gradcov %.3e | limits ll %.0e grad %.0e (%.1f s)"
            % (label, r["m"], r["B"], r["E"], r["device"]["ll"],
               r["device"]["gradX"], r["device"]["gradcov"], cpu["ll"],
               cpu["gradX"], cpu["gradcov"], parity.LL_RTOL,
               parity.GRAD_RTOL, time.time() - t0))
        failures += ["%s: %s" % (label, f) for f in r["failures"]]
        results.append((label, r))
    check(not failures, "parity failures: %s" % failures)
    return results


def phase_correctness() -> None:
    flag = flagship_data().build_gprf(local_dist=flagship_args().local_dist)
    _, means, SY, cov = seismic_inputs(os.path.join(OUT, "seismic_data"))
    a = seismic_args()
    seis = seismic_problem(means, SY, cov, a.rpc_blocksize, a.threshold)
    wide = wide_problem()
    check(512 < wide.layout.block_pad <= 1024,
          "the wide slice has m=%d, outside (512, 1024]" % wide.layout.block_pad)
    correctness_phase([("flagship", flag), ("seismic", seis), ("wide", wide)])


# ---- four cards ----------------------------------------------------------


def phase_four_cards() -> None:
    """The sharded engines on a 1-d mesh over four cards against one card,
    at the flagship width and the seismic deployment's size."""
    import jax

    from gprf_tpu.parallel.mesh_check import run_mesh_checks
    from gprf_tpu.parallel.sharding import make_mesh

    jax.config.update("jax_enable_x64", True)
    mesh = make_mesh(jax.devices()[:4])
    t0 = time.time()
    r = run_mesh_checks(mesh, n=10000, nblocks=100, dy=50, seismic_n=12000,
                        seismic_blocksize=210)
    say("four cards (%.1f s): %s" % (time.time() - t0, json.dumps(r)))
    peaks = r.get("peak_bytes")
    if peaks:
        say("peak bytes in use per card after the sharded loss: %s" % peaks)
        check(min(peaks[1:]) >= 0.2 * peaks[0], (
            "the sharded loss left cards 1-3 nearly idle: %s" % peaks
        ))


# ---- main ----------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)

    try:
        import gprf_tpu  # noqa: F401
    except ImportError as e:
        say("chip_smoke.py must run from the repository's root: %s" % e)
        return 2
    from gprf_tpu.utils.compile_cache import configure_compile_cache

    try:
        info = phase_device(4 if args.four_cards else 1)
    except RuntimeError as e:
        say("device check failed: %s" % e)
        return 2
    configure_compile_cache()

    if args.four_cards:
        phase_four_cards()
    else:
        os.makedirs(OUT, exist_ok=True)
        for sub in ("flagship_device", "flagship_host", "flagship_multistart",
                    "seismic_experiments"):
            shutil.rmtree(os.path.join(OUT, sub), ignore_errors=True)
        check_imports()
        for phase in (phase_flagship_device, phase_flagship_host,
                      phase_multistart, phase_seismic, phase_correctness):
            t0 = time.time()
            say("== %s" % phase.__name__)
            phase()
            say("== %s passed (%.1f s)" % (phase.__name__, time.time() - t0))
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
