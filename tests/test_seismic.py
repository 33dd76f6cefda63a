"""Seismic dataset + CLI end-to-end tests (CPU, small synthetic catalog)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from gprf_tpu.data.seismic import (
    COL_DEPTH,
    COL_LAT,
    COL_LON,
    COL_SMAJ,
    dist_deg,
    dist_km,
    dist_lld,
    load_data,
    mad,
    make_synthetic_catalog,
    make_x_prior,
)


def test_dist_deg_doctests():
    # the reference doctest cases (run_seismic.py:24-33)
    assert int(dist_deg((10, 0), (20, 0))) == 10
    assert int(dist_deg((10, 0), (10, 45))) == 45
    assert int(dist_deg((-78, -12), (-10.25, 52))) == 86
    assert dist_deg((132.86521, -0.45606493), (132.86521, -0.45606493)) < 1e-4
    assert dist_deg((127.20443, 2.8123965), (127.20443, 2.8123965)) < 1e-4


def test_dist_lld():
    a = (130.0, 2.0, 10.0)
    b = (130.0, 2.0, 50.0)
    assert np.isclose(dist_lld(a, b), 40.0)
    c = (131.0, 2.0, 10.0)
    d_surface = dist_km((130.0, 2.0), (131.0, 2.0))
    assert np.isclose(dist_lld(a, c), d_surface)


def test_make_synthetic_catalog():
    cat = make_synthetic_catalog(n=500, seed=0)
    assert cat.shape == (500, 9)
    assert np.all(cat[:, COL_SMAJ] > 0)
    assert np.all(cat[:, COL_DEPTH] >= 0)
    # morton-sorted: consecutive events spatially close on average
    ll = cat[:, [COL_LON, COL_LAT]]
    steps = np.linalg.norm(np.diff(ll, axis=0), axis=1)
    rng = np.random.default_rng(0)
    shuffled = ll[rng.permutation(len(ll))]
    steps_shuffled = np.linalg.norm(np.diff(shuffled, axis=0), axis=1)
    assert np.median(steps) < 0.5 * np.median(steps_shuffled)


def test_load_data_caches(tmp_path):
    cat = make_synthetic_catalog(n=120, seed=1)
    np.save(tmp_path / "sorted_isc.npy", cat)
    isc, SY, cov = load_data(40.0, 0, data_dir=str(tmp_path))
    assert isc.shape == (120, 9)
    assert SY.shape == (120, 50)
    assert cov.dfn_str == "lld" and cov.wfn_str == "matern32"
    assert os.path.exists(tmp_path / "seismic_Y_40.0_0.npy")
    # second load reuses the cached Y
    isc2, SY2, _ = load_data(40.0, 0, data_dir=str(tmp_path))
    np.testing.assert_array_equal(SY, SY2)


def test_x_prior_grad_matches_fd():
    rng = np.random.default_rng(0)
    means = rng.normal(size=(10, 3))
    prior_std = np.array([0.2, 0.2, 20.0])
    x_prior = make_x_prior(means, prior_std)
    X = means + rng.normal(size=(10, 3)) * prior_std
    ll, g = x_prior(X)
    from reference_impl import fd_grad

    fd = fd_grad(lambda x: x_prior(x.reshape(10, 3))[0], X.copy().reshape(-1), eps=1e-6)
    np.testing.assert_allclose(g.reshape(-1), fd, rtol=1e-5, atol=1e-7)


def test_mad():
    X1 = np.array([[130.0, 2.0, 10.0], [131.0, 3.0, 20.0]])
    X2 = X1.copy()
    X2[0, 2] += 30.0
    m, md = mad(X1, X2)
    assert np.isclose(m, 15.0)
    assert np.isclose(md, 15.0)


@pytest.mark.slow
def test_seismic_cli_end_to_end(tmp_path):
    """Run the seismic CLI on a tiny catalog on CPU; check protocol files
    and that location error decreases."""
    cat = make_synthetic_catalog(n=200, seed=2)
    np.save(tmp_path / "sorted_isc.npy", cat)
    env = dict(os.environ)
    env["SEISMIC_EXPERIMENTS"] = str(tmp_path / "exp")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [
            sys.executable,
            "-m",
            "gprf_tpu.cli.run_seismic",
            "--npts=-1",
            "--obs_std=20.0",
            "--threshold=0.5",
            "--synth_lscale=40.0",
            "--rpc_blocksize=60",
            "--task=x",
            "--maxsec=60",
            f"--data_dir={tmp_path}",
        ],
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    exp_dirs = list((tmp_path / "exp").iterdir())
    assert len(exp_dirs) == 1
    d = exp_dirs[0]
    assert (d / "finished").exists()
    assert (d / "results.txt").exists()
    lines = (d / "results.txt").read_text().strip().split("\n")
    assert lines[-1].startswith("true X ll")
    first = lines[0].split(" ")
    last = lines[-2].split(" ")
    # col 4 is mean km error; optimization should reduce it
    assert float(last[4]) < float(first[4])
    # neighbor cache written
    assert any(f.name.startswith("neighbors_") for f in tmp_path.iterdir())
