"""LOD-score conversions.

- ``r2lod``: correlation -> LOD, the elementwise map applied to the big
  correlation GEMM output (reference src/bulkscan_helpers.jl:22-24). Pure jnp,
  fused by XLA into the surrounding computation.
- ``p2lod`` / ``lod2p`` / ``lod2log10p``: chi-square LRT <-> p-value
  conversions (reference src/util.jl:181-206). These are result
  post-processing; the host variants use scipy for full tail accuracy, and
  ``lod2log10p_device`` is a jnp variant usable inside jit.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import gammaincc

_LN10 = math.log(10.0)


_LN2_F32 = 0.6931471805599453
_LOG10E_F32 = 0.4342944819032518
_SQRT2 = 1.4142135623730951


def log10_f32_accurate(x):
    """Float32 log10 with ~1e-7 absolute error on every backend.

    A backend's native f32 ``log`` may be an approximation (some
    accelerators' reach ~1e-4 absolute error; multiplied by n/2 that alone
    costs ~1e-3 LOD). This routine does exact exponent/mantissa extraction
    (bitcast) and an
    atanh-series polynomial on the mantissa: ln(m) = 2t(1 + t^2/3 + ... +
    t^8/9), t = (m-1)/(m+1), |t| <= 0.1716 after shifting m into
    [sqrt(1/2), sqrt(2)). ~12 VPU FMAs per element — far cheaper than an
    emulated f64 log and ~1000x more accurate than the native f32 one.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    bits = jax.lax.bitcast_convert_type(x, jnp.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = jax.lax.bitcast_convert_type(
        (bits & 0x007FFFFF) | (127 << 23), jnp.float32
    )  # mantissa in [1, 2)
    shift = m > _SQRT2
    m = jnp.where(shift, 0.5 * m, m)
    e = (e + shift.astype(jnp.int32)).astype(jnp.float32)
    t = (m - 1.0) / (m + 1.0)
    t2 = t * t
    p = 1.0 + t2 * (1.0 / 3.0 + t2 * (1.0 / 5.0 + t2 * (1.0 / 7.0 + t2 * (1.0 / 9.0))))
    ln = e * _LN2_F32 + 2.0 * t * p
    out = ln * _LOG10E_F32
    # domain guard: non-positive input (r^2 >= 1 after rounding) -> nan, like log10
    return jnp.where(x > 0.0, out, jnp.nan)


def r2lod(r, n, *, fast_log: bool = False):
    """LOD = -(n/2) * log10(1 - r^2) for correlation r and sample size n.

    ``fast_log``: form the cancellation-sensitive ``1 - r^2`` in the input
    dtype (f64 in mixed mode), then take the log in f32 via
    :func:`log10_f32_accurate`, which keeps the (p, m) epilogue in f32
    without relying on a backend's native f32 log.

    ``1 - r^2`` is floored at dtype-tiny: near-collinear markers can carry
    enough cancellation noise in the numerator that the computed |r|
    rounds past 1 (the residual floors bound the DENOMINATOR only), and an
    unguarded log would turn one degenerate marker into a NaN that
    poisons every max-reduction downstream (genome-wide maxima,
    permutation thresholds). The floor maps such markers to a huge finite
    LOD instead — the documented degenerate behavior
    (ops/smallchol.py::residual_sq), matching maxr2_to_lod.
    """
    one_minus_r2 = 1.0 - r * r
    if fast_log:
        # the floor must survive the f32 cast: an f64-tiny floor would
        # underflow to 0.0 and log10_f32_accurate(0) is NaN
        one_minus_r2 = jnp.maximum(
            one_minus_r2, jnp.asarray(jnp.finfo(jnp.float32).tiny,
                                      one_minus_r2.dtype)
        )
        return -(n / 2.0) * log10_f32_accurate(one_minus_r2.astype(jnp.float32))
    one_minus_r2 = jnp.maximum(one_minus_r2, jnp.finfo(one_minus_r2.dtype).tiny)
    return -(n / 2.0) * jnp.log10(one_minus_r2)


def rss2lod(rss1, rss0, n):
    """LOD from null/alt residual sums of squares: (n/2) log10(rss0/rss1).

    Equivalent to the reference's per-marker formula
    ``(-n/2)(log10 rss1 - log10 rss0)`` (src/scan.jl:449).
    """
    return (n / 2.0) * (jnp.log10(rss0) - jnp.log10(rss1))


def p2lod(pval, df: int):
    """p-value -> LOD: inverse chi-square CDF of (1 - p), over 2 ln10 (host)."""
    from scipy.stats import chi2

    lrs = chi2.isf(np.asarray(pval), df)
    return lrs / (2.0 * _LN10)


def lod2p(lod, df: int):
    """LOD -> p-value: chi-square survival function of LOD * 2 ln10 (host)."""
    from scipy.stats import chi2

    lrs = np.asarray(lod) * 2.0 * _LN10
    return chi2.sf(lrs, df)


def lod2log10p(lod, df: int):
    """LOD -> -log10(p-value), accurate deep into the tail (host, scipy)."""
    from scipy.stats import chi2

    lrs = np.asarray(lod) * 2.0 * _LN10
    return -chi2.logsf(lrs, df) / _LN10


def lod2log10p_device(lod, df: int):
    """LOD -> -log10(p) with jnp (jit-safe). Accurate for moderate LODs;
    for very large LODs (p underflowing float64) prefer the host variant."""
    lrs = lod * 2.0 * _LN10
    sf = gammaincc(df / 2.0, lrs / 2.0)
    sf = jnp.maximum(sf, jnp.finfo(jnp.asarray(lod).dtype).tiny)
    return -jnp.log10(sf)
