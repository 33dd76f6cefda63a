"""chip_smoke.py without a card: it refuses the CPU, and its correctness
phase runs at a tiny size against the f64 oracle."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_refuses_cpu_and_prints_no_result(argv, capsys):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out
    assert "device check failed" in out
    assert not any(line.startswith("{") for line in out.splitlines())


def test_lone_script_exits_nonzero(tmp_path):
    """Copied alone into an empty directory, the script fails without a
    result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert not any(line.startswith("{") for line in r.stdout.splitlines())


def _tiny_problems():
    from gprf_tpu.data.seismic import (
        COL_DEPTH, COL_LAT, COL_LON, make_synthetic_catalog,
    )
    from gprf_tpu.kernels.gpcov import GPCov
    from gprf_tpu.model.gprf import GPRF
    from gprf_tpu.partition.grid import Blocker, grid_centers

    rng = np.random.default_rng(0)
    X = rng.uniform(size=(120, 2))
    b = Blocker(grid_centers(9))
    flag = GPRF(X, rng.standard_normal((120, 4)), None,
                GPCov.create([1.0], [0.2, 0.2]), 0.01,
                block_idxs=b.block_clusters(X), neighbors=b.neighbors())
    cat = make_synthetic_catalog(n=160, seed=3)
    means = cat[:, (COL_LON, COL_LAT, COL_DEPTH)]
    seis = chip_smoke.seismic_problem(
        means, rng.standard_normal((160, 4)),
        GPCov.create([1.0], [40.0, 40.0], "lld", "matern32"),
        blocksize=40, threshold=0.6,
    )
    wide = chip_smoke.wide_problem(n=150, nblocks=4, dy=3)
    return {"flagship": flag, "seismic": seis, "wide": wide}


@pytest.mark.parametrize("label", ["flagship", "seismic", "wide"])
def test_correctness_phase_tiny(label):
    g = _tiny_problems()[label]
    assert g.layout.n_edges > 0
    [(got_label, r)] = chip_smoke.correctness_phase([(label, g)])
    assert got_label == label and r["ok"]
    assert r["device"]["ll"] < 1e-4 and r["cpu"] is not None


def test_wide_problem_reaches_the_wide_regime():
    """The default wide slice has the 80k/100-block deployment's width."""
    g = chip_smoke.wide_problem()
    assert 512 < g.layout.block_pad <= 1024
    assert g.n_blocks == 9 and g.layout.n_edges == 12


def test_last_line_contract_fields():
    """The result line carries exactly what the device check returns."""
    from gprf_tpu.utils.device import device_info

    line = json.dumps({"ok": True, "device": device_info()})
    assert set(json.loads(line)["device"]) == {"platform", "kind", "count"}
