"""Entry-point contract tests: ``__graft_entry__.entry()`` compiles and
runs, and ``dryrun_multichip(n)`` passes from a process that starts with
fewer devices than it needs (it re-runs itself on n virtual CPU devices).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env(n_devices: int) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = [
        f
        for f in env.get("XLA_FLAGS", "").split()
        if not f.startswith("--xla_force_host_platform_device_count")
    ]
    flags.append(f"--xla_force_host_platform_device_count={n_devices}")
    env["XLA_FLAGS"] = " ".join(flags)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p
    )
    return env


@pytest.mark.slow
def test_dryrun_multichip_respawns_from_one_device():
    """dryrun_multichip(4) from a 1-device process must exit 0."""
    r = subprocess.run(
        [sys.executable, "-c", "import __graft_entry__ as e; e.dryrun_multichip(4)"],
        env=_cpu_env(1),
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert r.returncode == 0, (
        f"dryrun failed:\nstdout={r.stdout[-4000:]}\nstderr={r.stderr[-4000:]}"
    )
    assert "dryrun_multichip(4)" in r.stdout


@pytest.mark.slow
def test_entry_compiles_and_runs():
    """entry() hands back a jittable (fn, args): finite value, grad of
    theta's shape."""
    code = """
import jax
import numpy as np
import __graft_entry__ as e
fn, args = e.entry()
val, grad = jax.device_get(jax.jit(fn)(*args))
assert np.isfinite(val), val
assert grad.shape == args[0].shape, (grad.shape, args[0].shape)
assert np.all(np.isfinite(grad))
print("entry-ok", float(val))
"""
    r = subprocess.run(
        [sys.executable, "-c", code],
        env=_cpu_env(1),
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert r.returncode == 0, (
        f"entry check failed:\nstdout={r.stdout[-4000:]}\nstderr={r.stderr[-4000:]}"
    )
    assert "entry-ok" in r.stdout
