"""Experiment fleet generation: reproduce the paper's run suites.

Rebuild of the suite generators and launcher-script emitters in the
reference (``gprfopt_analyze.py:188-387``): the "eighty" suite (80k points,
local vs GPRF block counts), the "truegp" suite (10k points, local/GPRF vs
inducing-point baselines), and the "fitc" scaling suite (2k-80k points),
plus :func:`gen_runexp`, which writes one shell command per experiment
(``run_eighty.sh`` / ``run_truegp.sh`` / ``run_fitc.sh``).  Fleet
parallelism in the reference is independent shell jobs (``run_cloud.sh``) —
the same model applies here, one accelerator process per experiment.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def eighty_run_params():
    """80k-point suite (reference ``gprfopt_analyze.py:188-229``)."""
    yd, seed, method, ntest = 50, 0, "l-bfgs-b", 500
    ntrain = 80000
    local_nblocks = [16, 36, 100, 196, 400, 900]
    gprf_nblocks = [100, 196, 400, 900]
    lscale = 6.0 / np.sqrt(ntrain)
    obs_std = 2.0 / np.sqrt(ntrain)
    runs, runs_by_key = [], defaultdict(list)
    for nblocks in local_nblocks:
        p = dict(ntrain=ntrain, ntest=ntest, lscale=lscale, obs_std=obs_std,
                 yd=yd, seed=seed, local_dist=1.0, method=method,
                 nblocks=nblocks, task="x", noise_var=0.01, num_inducing=0)
        runs.append(p)
        runs_by_key["Local-%d" % nblocks].append(p)
    for nblocks in gprf_nblocks:
        p = dict(ntrain=ntrain, ntest=ntest, lscale=lscale, obs_std=obs_std,
                 yd=yd, seed=seed, local_dist=0.1, method=method,
                 nblocks=nblocks, task="x", noise_var=0.01, num_inducing=0)
        runs.append(p)
        runs_by_key["GPRF-%d" % nblocks].append(p)
    return runs, runs_by_key


def truegp_run_params():
    """10k-point suite incl. inducing-point baselines
    (reference ``gprfopt_analyze.py:231-278``)."""
    yd, seed, method, ntest = 50, 0, "l-bfgs-b", 500
    ntrain = 10000
    local_nblocks = [1, 9, 25, 49, 100]
    gprf_nblocks = [9, 25, 49, 100]
    ns_inducing = [200, 500, 1000, 2000]
    lscale = 6.0 / np.sqrt(ntrain)
    obs_std = 2.0 / np.sqrt(ntrain)
    runs, runs_by_key = [], defaultdict(list)
    for nblocks in local_nblocks:
        p = dict(ntrain=ntrain, ntest=ntest, lscale=lscale, obs_std=obs_std,
                 yd=yd, seed=seed, local_dist=1.0, method=method,
                 nblocks=nblocks, task="x", noise_var=0.01, num_inducing=0)
        runs.append(p)
        runs_by_key["Local-%d" % nblocks].append(p)
    for nblocks in gprf_nblocks:
        p = dict(ntrain=ntrain, ntest=ntest, lscale=lscale, obs_std=obs_std,
                 yd=yd, seed=seed, local_dist=0.1, method=method,
                 nblocks=nblocks, task="x", noise_var=0.01, num_inducing=0)
        runs.append(p)
        runs_by_key["GPRF-%d" % nblocks].append(p)
    for num_inducing in ns_inducing:
        p = dict(ntrain=ntrain, ntest=ntest, lscale=lscale, obs_std=obs_std,
                 yd=yd, seed=seed, method=method, task="x", noise_var=0.01,
                 gplvm_type="sparse", num_inducing=num_inducing, nblocks=1,
                 local_dist=1.0)
        runs.append(p)
        runs_by_key["FITC-%d" % num_inducing].append(p)
    return runs, runs_by_key


def fitc_run_params(obs_std_base=2.0):
    """Scaling suite over n (reference ``gprfopt_analyze.py:280-347``)."""
    yd, seed, method, ntest = 50, 0, "l-bfgs-b", 500
    ntrains = [2000, 5000] + list(range(10000, 85000, 5000))
    ns_inducing = [200, 500, 1000, 2000]
    block_sizes = [200, 400]

    def get_nblocks(ntrain, block_size_target):
        return int(np.floor(np.sqrt(ntrain / float(block_size_target)))) ** 2

    runs, runs_by_key = [], defaultdict(list)
    for ntrain in ntrains:
        lscale = 6.0 / np.sqrt(ntrain)
        obs_std = obs_std_base / np.sqrt(ntrain)
        for blocksize in block_sizes:
            nblocks = get_nblocks(ntrain, blocksize)
            if ntrain / float(nblocks) >= 8000:
                continue
            p = dict(ntrain=ntrain, ntest=ntest, lscale=lscale,
                     obs_std=obs_std, yd=yd, seed=seed, local_dist=1.0,
                     method=method, nblocks=nblocks, task="xcov",
                     noise_var=0.01, num_inducing=0)
            runs.append(p)
            runs_by_key["Local-%d" % blocksize].append(p)
        for blocksize in block_sizes:
            nblocks = get_nblocks(ntrain, blocksize)
            p = dict(ntrain=ntrain, ntest=ntest, lscale=lscale,
                     obs_std=obs_std, yd=yd, seed=seed, local_dist=0.1,
                     method=method, nblocks=nblocks, task="xcov",
                     noise_var=0.01, num_inducing=0)
            runs.append(p)
            runs_by_key["GPRF-%d" % blocksize].append(p)
        for num_inducing in ns_inducing:
            if num_inducing >= ntrain:
                continue
            p = dict(ntrain=ntrain, ntest=ntest, lscale=lscale,
                     obs_std=obs_std, yd=yd, seed=seed, method=method,
                     task="xcov", noise_var=0.01, gplvm_type="sparse",
                     num_inducing=num_inducing, nblocks=1, local_dist=1.0)
            runs.append(p)
            runs_by_key["FITC-%d" % num_inducing].append(p)
    return runs, runs_by_key


def gen_runexp(runs, base_cmd, outfile, tail="", analyze=False, parallel=False, maxsec=5400):
    """Write one launcher command per experiment
    (reference ``gprfopt_analyze.py:352-370``)."""
    with open(outfile, "w") as f_out:
        for run in runs:
            args = [
                "--%s=%s" % (k, v)
                for (k, v) in sorted(run.items(), key=lambda x: x[0])
                if k != "init_true"
            ]
            if analyze:
                args.append("--analyze")
                args.append("--analyze_full")
            if parallel:
                args.append("--parallel")
            if run.get("init_true"):
                args.append("--init_true")
            if "maxsec" not in run and maxsec is not None:
                args.append("--maxsec=%d" % maxsec)
            f_out.write(base_cmd + " " + " ".join(args) + tail + "\n")


def gen_runs(out_dir="."):
    """Emit run_eighty.sh / run_truegp.sh / run_fitc.sh
    (reference ``gprfopt_analyze.py:372-387``)."""
    import os

    base = "python -m gprf_tpu.cli.gprfopt"
    runs_eighty, _ = eighty_run_params()
    runs_truegp, _ = truegp_run_params()
    runs_fitc, _ = fitc_run_params()
    gen_runexp(runs_eighty, base, os.path.join(out_dir, "run_eighty.sh"), maxsec=86400)
    gen_runexp(runs_truegp, base, os.path.join(out_dir, "run_truegp.sh"), maxsec=18000)
    gen_runexp(runs_fitc, base, os.path.join(out_dir, "run_fitc.sh"), maxsec=36000)
