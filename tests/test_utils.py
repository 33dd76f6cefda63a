"""Compile-cache location, device naming, and the FLOP model's peaks."""

import os

import jax
import pytest

from gprf_tpu.utils import compile_cache
from gprf_tpu.utils.device import device_info, require_gpu
from gprf_tpu.utils.flops import (
    PEAK_F32_FLOPS,
    model_flops_per_eval,
    peak_f32_flops,
    roofline_str,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_env_set_sets_nothing(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.configure_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_env_unset_uses_fixed_repo_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.configure_compile_cache()
    assert d == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == d
    # the same path on every call: never a temporary name, pid or time
    assert compile_cache.configure_compile_cache() == d


def test_cache_dir_is_git_ignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = f.read().split()
    assert ".jax_cache/" in ignored and "smoke_out/" in ignored


def test_h100_peak_found():
    assert peak_f32_flops("NVIDIA H100 80GB HBM3") == 67e12
    assert set(PEAK_F32_FLOPS) == {"NVIDIA H100 80GB HBM3"}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(ValueError, match="no published f32 peak"):
        peak_f32_flops(kind)


def test_roofline_str_uses_the_table():
    s = roofline_str(67e9, 1e-3, "NVIDIA H100 80GB HBM3")
    assert s == "67000 GFLOP/s (100.00% of f32 peak)"


def test_flagship_pair_pass_dominates_flop_model():
    """At the flagship (B=100, E=180, m=136) the pair pass is ~18x the
    unary factorization in the model the benchmark divides by."""
    pair_only = model_flops_per_eval(B=0, m=136, E=180, dy=50, dx=2)
    unary_only = model_flops_per_eval(B=100, m=136, E=0, dy=50, dx=2)
    assert 10 < pair_only / unary_only < 25


def test_device_info_names_the_cpu_here():
    info = device_info()
    assert info["platform"] == "cpu" and info["count"] == len(jax.devices())
    assert set(info) == {"platform", "kind", "count"}


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


def test_bench_refuses_cpu():
    import bench

    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()
