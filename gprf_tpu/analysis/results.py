"""Results protocol: per-step metrics recomputed from checkpoints.

Writer/reader for the reference ``results.txt`` format so downstream
analysis tooling ports unchanged: 12 fixed columns
(``gprfopt_analyze.py:20-22``) — step, time, mll, dlscale, mad, xprior,
smse_local, smse, msll_local_block, msll_block, msll_local_diag, msll_diag —
plus a final ``trueX`` oracle row with the objective evaluated at the true
latents (``gprfopt.py:490-515``), which doubles as the end-to-end
correctness oracle: the optimized objective should approach the true-X
objective.
"""

from __future__ import annotations

import os

import numpy as np

from gprf_tpu.optim.driver import load_log
from gprf_tpu.utils.io import step_cov_path, step_x_path

RESULT_COLS = {
    "step": 0,
    "time": 1,
    "mll": 2,
    "dlscale": 3,
    "mad": 4,
    "xprior": 5,
    "smse_local": 6,
    "smse": 7,
    "msll_local_block": 8,
    "msll_block": 9,
    "msll_local_diag": 10,
    "msll_diag": 11,
}


def analyze_run(d, sdata, local_dist=1.0, predict=False, X0=None):
    """Recompute metrics for every checkpointed step and write results.txt
    (reference ``analyze_run``, ``gprfopt.py:453-516``).

    ``X0`` is the run's actual initial/pinned latents — the fallback when a
    row has no X checkpoint.  task=cov runs pin X at the TRUE latents and
    never checkpoint X, so the default X_obs fallback would misreport
    their metrics; the CLI passes the per-task anchor."""
    steps, times, lls = load_log(d)
    rfname = os.path.join(d, "results.txt")
    results = open(rfname, "w")

    def row_metrics(X, FC, predict_flag):
        l1 = sdata.mean_distance(X.flatten())
        c1 = sdata.lscale_error(FC) if FC is not None else 0.0
        l2 = sdata.x_prior(X.flatten())[0]
        if predict_flag:
            smse_local, msll_local_block, msll_local_diag = sdata.prediction_error(
                X=X, cov=FC, local_dist=1.0
            )
            if local_dist < 1.0:
                smse, msll_block, msll_diag = sdata.prediction_error(
                    X=X, cov=FC, local_dist=local_dist
                )
            else:
                smse, msll_block, msll_diag = smse_local, msll_local_block, msll_local_diag
        else:
            smse = smse_local = msll_local_block = msll_block = msll_local_diag = msll_diag = 0.0
        return c1, l1, l2, smse_local, smse, msll_local_block, msll_block, msll_local_diag, msll_diag

    # the device loop checkpoints every steps_per_dispatch iterations while
    # log.txt has a row per iteration: rows between checkpoints carry the
    # last checkpointed state forward (initial state = the observed X, the
    # optimizer's starting point — NEVER the true latents, which would
    # report oracle-quality metrics for steps that never achieved them),
    # and their metrics are reused rather than recomputed
    prev_X, prev_FC, prev_metrics = None, None, None
    for i, step in enumerate(steps):
        loaded = False
        try:
            X = np.load(step_x_path(d, step))
            loaded = True
        except (IOError, OSError):
            X = prev_X if prev_X is not None else np.asarray(
                X0 if X0 is not None else sdata.X_obs
            )
        try:
            FC = np.load(step_cov_path(d, step))
            loaded = True
        except (IOError, OSError):
            FC = prev_FC
        if loaded or prev_metrics is None:
            prev_metrics = row_metrics(X, FC, predict)
            prev_X, prev_FC = X, FC
        c1, l1, l2, smse_local, smse, mlb, mb, mld, md = prev_metrics
        s = "%d %.2f %.2f %.8f %.8f %.8f %.4f %.4f %.4f %.4f %.4f %.4f" % (
            step, times[i], lls[i], c1, l1, l2, smse_local, smse, mlb, mb, mld, md,
        )
        results.write(s + "\n")

    # oracle row: objective at the true latents
    X = sdata.SX
    c1, l1, l2, smse_local, smse, mlb, mb, mld, md = row_metrics(
        X, None, predict
    )
    results.flush()
    # single-block (full GP) included: one masked block term
    ll1 = sdata.build_gprf(X=X, local_dist=local_dist).llgrad()[0]
    s = "trueX inf %.2f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f" % (
        ll1, c1, l1, l2, smse_local, smse, mlb, mb, mld, md,
    )
    results.write(s + "\n")
    results.close()
    return rfname


def load_results(d):
    r = os.path.join(d, "results.txt")
    results = []
    with open(r, "r") as rf:
        for line in rf:
            try:
                results.append([float(x) for x in line.split(" ")])
            except ValueError:
                continue
    return np.asarray(results)


def read_result_line(s):
    r = {}
    parts = s.split(" ")
    for lbl, col in RESULT_COLS.items():
        p = parts[col]
        if p == "trueX":
            continue
        try:
            r[lbl] = int(p)
        except ValueError:
            r[lbl] = float(p)
    return r


def load_final_results(d):
    """(final_row, trueX_row) dicts from a finished run
    (reference ``gprfopt_analyze.py:56-62``)."""
    with open(os.path.join(d, "results.txt"), "r") as rf:
        lines = rf.readlines()
    return read_result_line(lines[-2]), read_result_line(lines[-1])


def max_history(values):
    """Best-so-far envelope (the notebook's ``max_history``,
    ``gprf_camera_plot.ipynb`` cell 1)."""
    out = []
    best = -np.inf
    for v in values:
        best = max(best, v)
        out.append(best)
    return np.asarray(out)


def compare_seismic_runs(d1, d2, data_dir="."):
    """Mean/median km distance between the final inferred locations of two
    seismic runs (reference ``seismic/analyze_seismic.py``): loads the last
    ``step_*_X.npy`` of each run dir and compares pointwise."""
    import os as _os

    from gprf_tpu.data.seismic import mad

    def last_X(d):
        fnames = sorted(
            f for f in _os.listdir(d) if f.startswith("step") and f.endswith("_X.npy")
        )
        if not fnames:
            raise FileNotFoundError(f"no step checkpoints in {d}")
        return np.load(_os.path.join(d, fnames[-1]))

    X1, X2 = last_X(d1), last_X(d2)
    if len(X1) != len(X2):
        raise ValueError("runs have different point counts")
    return mad(X1, X2)
