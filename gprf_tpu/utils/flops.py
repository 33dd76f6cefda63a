"""Analytic FLOP model for the fused GPRF objective+gradient.

Gives roofline context ("actually fast, or just correct?") for the timed
shapes: the flagship (B=100, m=136), the seismic partition (m=192), and the
80k wide-m step (m~888).  This is a *model* — it tracks arithmetic-intensity
regressions across ablations, not a hardware counter.  The counted terms
mirror the fused Schur evaluation (``gprf_tpu/model/objective.py``); the
reference implements the same math per-block on CPU LAPACK
(reference ``gprf.py:496-591``).
"""

from __future__ import annotations

# Published float32 peaks (FLOP/s), keyed by ``jax.Device.device_kind``.
# The objective runs its matmuls at HIGHEST precision, i.e. plain f32
# outside the tensor cores, so the f32 (not TF32) rate is the ceiling.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part, FP32 column
# (67 TFLOP/s, dense, at the 700 W power limit).
PEAK_F32_FLOPS = {
    "NVIDIA H100 80GB HBM3": 67e12,
}


def peak_f32_flops(device_kind: str) -> float:
    """Published f32 peak of a device; a device missing from the table is
    an error, never a default."""
    try:
        return PEAK_F32_FLOPS[device_kind]
    except KeyError:
        raise ValueError(
            "no published f32 peak for device kind %r; add it to "
            "gprf_tpu.utils.flops.PEAK_F32_FLOPS with its source" % device_kind
        ) from None


def model_flops_per_eval(B, m, E, dy, dx, passes=3.0):
    """Analytic FLOP count of one fused Schur objective(+gradient) eval.

    Forward terms (per batch element of width m):
      unary:  kernel build 2 m^2 dx (quadratic-expansion matmul) + Cholesky
              m^3/3 + dy-rhs triangular solve m^2 dy
      pair:   Kij build 2 m^2 dx + wide triangular solve m^3 + Schur
              product 2 m^3 + chol(S) m^3/3 + two dy-rhs updates 3 m^2 dy

    ``passes``: 3.0 for objective+gradient (reverse-mode costs ~2x forward;
    the custom VJPs are in the same regime: two triangular solves + an
    outer product per factorization), 1.0 for objective-only.
    """
    unary = B * (m**3 / 3.0 + m * m * dy + 2.0 * m * m * dx)
    pair = E * ((10.0 / 3.0) * m**3 + 3.0 * m * m * dy + 2.0 * m * m * dx)
    return passes * (unary + pair)


def roofline_str(flops, sec, device_kind: str):
    """'xx GFLOP/s (y.yy% of f32 peak)' for a measured wall time."""
    rate = flops / sec
    return "%.0f GFLOP/s (%.2f%% of f32 peak)" % (
        rate / 1e9,
        100.0 * rate / peak_f32_flops(device_kind),
    )
